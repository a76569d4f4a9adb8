"""Export a fine-tune (counterpart of the repository's
`scripts/exp/export.py`): copy a run's checkpoints into the models
directory's `loras/<name>/` layout, and upload them to a hub repo where
asked (the only step that needs the network; `huggingface_hub` is imported
for it alone).

    python -m vampnet_tpu_torch.scripts.exp.export --name my-model [--tag latest] \
        [--repo_id user/repo --upload]
"""
from __future__ import annotations

import shutil
from pathlib import Path

from ... import config as cfglib
from ...registry import MODELS_DIR


def export(name: str, tag: str = "latest", repo_id: str | None = None,
           upload: bool = False, runs_dir: str = "runs"):
    run_root = Path(runs_dir) / name
    out_dir = MODELS_DIR / "loras" / name
    out_dir.mkdir(parents=True, exist_ok=True)

    copied = []
    for model in ("coarse", "c2f"):
        src_dir = run_root / model / tag
        for fname in ("model.vtpu", "lora.vtpu"):
            src = src_dir / fname
            if src.exists():
                dst = out_dir / (f"{model}.vtpu" if fname == "model.vtpu"
                                 else f"{model}.lora.vtpu")
                shutil.copy(src, dst)
                copied.append(dst)
    if not copied:
        raise FileNotFoundError(f"no checkpoints found under {run_root}/*/{tag}")
    print(f"exported {len(copied)} files to {out_dir}:")
    for c in copied:
        print(f"  {c}")

    if upload:
        from huggingface_hub import HfApi

        api = HfApi()
        for path in copied:
            api.upload_file(path_or_fileobj=str(path), path_in_repo=f"loras/{name}/{path.name}",
                            repo_id=repo_id)
            print(f"uploaded {path.name} to {repo_id}")
    return out_dir


def main(argv=None):
    args = cfglib.parse_args(argv)
    return export(name=args["name"], tag=args.get("tag", "latest"), repo_id=args.get("repo_id"),
                  upload=bool(args.get("upload", False)), runs_dir=args.get("runs_dir", "runs"))


if __name__ == "__main__":
    main()
