"""2-D projections of extracted embeddings (counterpart of the
repository's `scripts/utils/visualize_embeddings.py`): t-SNE, PCA or UMAP,
plotted where matplotlib imports. sklearn, umap and matplotlib are
imported when a projection is made.

    python -m vampnet_tpu_torch.scripts.utils.visualize_embeddings --embeddings gtzan-embs \
        --method tsne
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ... import config as cfglib


def _reducer(method: str, n_components: int):
    if method == "tsne":
        from sklearn.manifold import TSNE

        return TSNE(n_components=n_components)
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=n_components)
    if method == "umap":
        from umap import UMAP

        return UMAP(n_components=n_components)
    raise ValueError(f"unknown method {method}")


def dim_reduce(emb: np.ndarray, labels, save_path: str, n_components: int = 2,
               method: str = "tsne", title: str = ""):
    """Project `emb` and save a scatter plot at `save_path`, or, without
    matplotlib, the projection as `.npy` beside it."""
    proj = _reducer(method, n_components).fit_transform(emb)
    try:
        import matplotlib
    except ImportError:
        np.save(Path(save_path).with_suffix(".npy"), proj)
        print("matplotlib unavailable; wrote the raw projection instead")
        return proj
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    for g in sorted(set(labels)):
        idx = [i for i, label in enumerate(labels) if label == g]
        ax.scatter(proj[idx, 0], proj[idx, 1], label=g, s=12)
    ax.legend(fontsize=7)
    ax.set_title(title or f"{method} projection")
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    print(f"wrote {save_path}")
    return proj


def main(argv=None):
    args = cfglib.parse_args(argv)
    emb_dir = Path(args["embeddings"])
    emb = np.load(emb_dir / "embeddings.npz")["embeddings"]
    labels = json.loads((emb_dir / "labels.json").read_text())
    return dim_reduce(emb, labels, save_path=args.get("save_path", str(emb_dir / "projection.png")),
                      method=args.get("method", "tsne"), title=args.get("title", ""))


if __name__ == "__main__":
    main()
