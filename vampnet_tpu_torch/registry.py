"""Model registry (counterpart of `vampnet_tpu/registry.py`): where the
codec, coarse, c2f and wavebeat checkpoints and the LoRA fine-tunes live,
and the hub download of missing ones.

Local files always win: `<MODELS_DIR>/{codec,coarse,c2f}.{vtpu,pth}` and
`<MODELS_DIR>/loras/<name>/{coarse,c2f}.{vtpu,pth}`, a `.vtpu` before the
`.pth` beside it. `MODELS_DIR` is `$VAMPNET_MODELS_DIR`, else
`models/vampnet` in the repository. `huggingface_hub` is imported only to
fetch a missing file; where it is absent or offline, a missing file raises
`FileNotFoundError` naming the path and the cause.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

ROOT = Path(__file__).parent.parent
MODELS_DIR = Path(os.environ.get("VAMPNET_MODELS_DIR", ROOT / "models" / "vampnet"))


def _default_repo() -> str:
    from . import DEFAULT_HF_MODEL_REPO

    repo_file = ROOT / "DEFAULT_HF_MODEL_REPO"
    if repo_file.exists():
        return repo_file.read_text().strip()
    return DEFAULT_HF_MODEL_REPO


def _clean_download_residue(base: Path, filename: str) -> None:
    """Remove what a failed download leaves under `<base>/.cache/huggingface`
    (`*.lock` files and `*.incomplete` blobs): a stale lock can wedge the
    retry of the same download."""
    cache = base / ".cache" / "huggingface"
    if not cache.exists():
        return
    stem = Path(filename).name
    for pattern in (f"**/{stem}*.lock", f"**/{stem}*.incomplete"):
        for p in cache.glob(pattern):
            try:
                p.unlink()
            except OSError:
                pass


def _hub_download(repo_id: str, filename: str, local_path: Path) -> str:
    if local_path.exists():
        return str(local_path)
    # the hub keeps `filename`'s directories under local_dir, so local_dir
    # is the base that makes local_dir/filename equal local_path
    base = Path(str(local_path)[: -len(filename)].rstrip("/"))
    try:
        from huggingface_hub import hf_hub_download

        local_path.parent.mkdir(parents=True, exist_ok=True)
        return hf_hub_download(repo_id=repo_id, filename=filename, local_dir=base)
    except Exception as e:  # absent package, offline, missing file: one answer
        _clean_download_residue(base, filename)
        raise FileNotFoundError(
            f"checkpoint {local_path} not found locally and hub download of "
            f"{repo_id}/{filename} failed: {e}"
        ) from e


def _prefer_native(local_pth: Path) -> Optional[Path]:
    """The `.vtpu` beside a `.pth`, if there is one."""
    native = local_pth.with_suffix(".vtpu")
    return native if native.exists() else None


def download_codec(repo_id: Optional[str] = None) -> str:
    native = _prefer_native(MODELS_DIR / "codec.pth")
    if native is not None:
        return str(native)
    return _hub_download(repo_id or _default_repo(), "codec.pth", MODELS_DIR / "codec.pth")


def download_default(repo_id: Optional[str] = None) -> Tuple[str, str]:
    """(coarse, c2f) paths. wavebeat is fetched too where it can be, and its
    absence is no error."""
    paths = []
    for filename in ["coarse.pth", "c2f.pth", "wavebeat.pth"]:
        native = _prefer_native(MODELS_DIR / filename)
        if native is not None:
            paths.append(str(native))
            continue
        try:
            paths.append(
                _hub_download(repo_id or _default_repo(), filename, MODELS_DIR / filename))
        except FileNotFoundError:
            if filename != "wavebeat.pth":
                raise
            paths.append(None)
    return paths[0], paths[1]


def download_finetuned(name: str, repo_id: Optional[str] = None) -> Tuple[str, str]:
    paths = []
    for filename in ["coarse.pth", "c2f.pth"]:
        local = MODELS_DIR / "loras" / name / filename
        native = _prefer_native(local)
        if native is not None:
            paths.append(str(native))
            continue
        paths.append(_hub_download(repo_id or _default_repo(), f"loras/{name}/{filename}", local))
    return paths[0], paths[1]


def list_finetuned(repo_id: Optional[str] = None) -> List[str]:
    """Fine-tune names: local `loras/*` directories holding a coarse or c2f
    checkpoint, with the hub's listing where it can be reached."""
    names = set()
    loras = MODELS_DIR / "loras"
    if loras.exists():
        for d in loras.iterdir():
            files = {p.name for p in d.iterdir()} if d.is_dir() else set()
            if {"coarse.pth", "c2f.pth"} & files or {"coarse.vtpu", "c2f.vtpu"} & files:
                names.add(d.name)
    try:
        from huggingface_hub import HfFileSystem

        fs = HfFileSystem()
        repo_id = repo_id or _default_repo()
        for item in fs.listdir(f"{repo_id}/loras"):
            item_names = [i["name"].split("/")[-1] for i in fs.listdir(item["name"])]
            if "c2f.pth" in item_names and "coarse.pth" in item_names:
                names.add(item["name"].split("/")[-1])
    except Exception:  # absent package or offline: the local listing stands
        pass
    return sorted(names)


def available_models() -> List[str]:
    return list_finetuned() + ["default"]
