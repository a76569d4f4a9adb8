"""Copy a dataset without the files quieter than a loudness cutoff
(counterpart of the repository's `scripts/utils/remove_quiet_files.py`).

    python -m vampnet_tpu_torch.scripts.utils.remove_quiet_files --src_dir in/ \
        --dest_dir out/ --min_loudness -30
"""
from __future__ import annotations

import shutil
from pathlib import Path

from ... import config as cfglib
from ...audio import AudioSignal
from ...train.datasets import find_audio


def remove_quiet_files(src_dir, dest_dir, min_loudness: float = -30):
    src_dir, dest_dir = Path(src_dir), Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    shutil.copytree(src_dir, dest_dir, dirs_exist_ok=True)

    removed = 0
    for audio_file in find_audio([str(dest_dir)]):
        if float(AudioSignal(audio_file).loudness()[0]) < min_loudness:
            audio_file.unlink()
            removed += 1
            print(f"removed {audio_file}")
    print(f"removed {removed} quiet files")
    return dest_dir


if __name__ == "__main__":
    args = cfglib.parse_args()
    remove_quiet_files(src_dir=args["src_dir"], dest_dir=args["dest_dir"],
                       min_loudness=float(args.get("min_loudness", -30)))
