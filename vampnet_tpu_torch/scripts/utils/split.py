"""Train/test split of an audio folder (counterpart of the repository's
`scripts/utils/split.py`): copies the files into `<folder>-train` and
`<folder>-test` beside it.

    python -m vampnet_tpu_torch.scripts.utils.split --audio_folder data/ --test_size 0.2 --yes
"""
from __future__ import annotations

import random
import shutil
from pathlib import Path

from ... import config as cfglib
from ...train.datasets import find_audio


def train_test_split(audio_folder: str = ".", test_size: float = 0.2, seed: int = 42,
                     assume_yes: bool = False):
    audio_folder = Path(audio_folder)
    audio_files = find_audio([str(audio_folder)])
    print(f"found {len(audio_files)} audio files")

    n_test = int(len(audio_files) * test_size)
    random.Random(seed).shuffle(audio_files)
    train_files = audio_files[: len(audio_files) - n_test]
    test_files = audio_files[len(audio_files) - n_test:]
    print(f"Train files: {len(train_files)}\nTest files: {len(test_files)}")

    if not assume_yes and (input("Continue [yn]? ") or "n") != "y":
        return None

    for split, files in (("train", train_files), ("test", test_files)):
        split_dir = audio_folder.parent / f"{audio_folder.name}-{split}"
        for f in files:
            out = split_dir / f.relative_to(audio_folder)
            out.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, out)
        print(f"wrote {len(files)} files to {split_dir}")
    return audio_folder


if __name__ == "__main__":
    args = cfglib.parse_args()
    train_test_split(audio_folder=args.get("audio_folder", "."),
                     test_size=float(args.get("test_size", 0.2)),
                     seed=int(args.get("seed", 42)), assume_yes=bool(args.get("yes", False)))
