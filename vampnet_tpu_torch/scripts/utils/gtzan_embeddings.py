"""Coarse-LM layer embeddings of a genre-labelled dataset (GTZAN's folder
layout), for probing (counterpart of the repository's
`scripts/utils/gtzan_embeddings.py`).

    python -m vampnet_tpu_torch.scripts.utils.gtzan_embeddings --args.load configs/interface.yml \
        --path_to_gtzan data/gtzan/genres_original --output_dir gtzan-embs [--device cpu]
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ... import config as cfglib
from ...audio import AudioSignal


@torch.inference_mode()
def layer_activations(lm, codes: torch.Tensor, codebooks: torch.Tensor) -> list:
    """Each transformer layer's output (b, t, d) for `codes`, before the
    final norm, caught by forward hooks."""
    acts = []
    hooks = [getattr(lm.transformer, f"layers_{i}").register_forward_hook(
                 lambda _m, _i, out: acts.append(out))
             for i in range(lm.config.n_layers)]
    try:
        lm.forward_codes(codes, codebooks)
    finally:
        for h in hooks:
            h.remove()
    return acts


def extract_embeddings(interface, path_to_gtzan: str, output_dir: str, duration: float = 10.0,
                       max_per_genre: int = 0, layer: int = -1):
    """The time mean of one coarse-LM layer's activations for each excerpt
    -> embeddings.npz and labels.json."""
    gtzan, output_dir = Path(path_to_gtzan), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    embs, labels = [], []
    lm = interface.coarse
    n_cb = lm.config.n_codebooks
    for genre_dir in sorted(d for d in gtzan.iterdir() if d.is_dir()):
        files = sorted(genre_dir.glob("*.wav")) + sorted(genre_dir.glob("*.au"))
        if max_per_genre:
            files = files[:max_per_genre]
        for f in files:
            sig = AudioSignal(f)
            sig.samples = sig.samples[..., : int(duration * sig.sample_rate)]
            codes = interface.encode(sig)[:, :n_cb, :]
            acts = layer_activations(lm, codes, interface.codebooks[:n_cb])
            embs.append(acts[layer].float().mean(dim=1)[0].cpu().numpy())
            labels.append(genre_dir.name)

    embs = np.stack(embs)
    np.savez(output_dir / "embeddings.npz", embeddings=embs)
    (output_dir / "labels.json").write_text(json.dumps(labels))
    print(f"wrote {len(labels)} embeddings ({embs.shape}) to {output_dir}")
    return embs, labels


def main(argv=None):
    from ...interface import Interface

    args = cfglib.parse_args(argv)
    interface = Interface.from_checkpoints(
        coarse_ckpt=args.get("Interface.coarse_ckpt"),
        coarse2fine_ckpt=args.get("Interface.coarse2fine_ckpt"),
        codec_ckpt=args.get("Interface.codec_ckpt"), device=args.get("device", "cuda"))
    return extract_embeddings(interface, path_to_gtzan=args["path_to_gtzan"],
                              output_dir=args.get("output_dir", "gtzan-embs"),
                              duration=float(args.get("duration", 10.0)),
                              max_per_genre=int(args.get("max_per_genre", 0)))


if __name__ == "__main__":
    main()
