"""Record the code a run starts from (counterpart of the repository's
`scripts/utils/stage.py`): a run directory with the git commit and the
uncommitted diff.

    python -m vampnet_tpu_torch.scripts.utils.stage --name my-run [--run_dir runs]
"""
from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path

from ... import config as cfglib


def run(run_dir: str = None, name: str = None, recent: bool = False):
    run_dir = Path(run_dir or os.getenv("PATH_TO_RUNS", "runs"))
    if recent:
        paths = sorted((p for p in run_dir.iterdir() if p.is_dir()), key=os.path.getmtime)
        if paths:
            name = paths[-1].name
    name = name or time.strftime("%Y%m%d-%H%M%S")
    exp_dir = run_dir / name
    exp_dir.mkdir(parents=True, exist_ok=True)

    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                check=True).stdout.strip()
        diff = subprocess.run(["git", "diff", "HEAD"], capture_output=True, text=True,
                              check=True).stdout
        (exp_dir / "git-commit.txt").write_text(commit)
        if diff:
            (exp_dir / "git-diff.patch").write_text(diff)
        print(f"Created a snapshot of {commit[:12]} at {exp_dir}")
    except subprocess.CalledProcessError:
        print(f"not a git repo; created bare run dir {exp_dir}")
    return exp_dir


if __name__ == "__main__":
    args = cfglib.parse_args()
    run(run_dir=args.get("run_dir"), name=args.get("name"), recent=bool(args.get("recent", False)))
