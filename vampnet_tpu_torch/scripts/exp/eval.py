"""Offline evaluation (counterpart of the repository's `scripts/exp/eval.py`):
score each condition directory of an experiment against its baseline
directory with the FAD and the mel loss, and write the statistics as CSV.

    python -m vampnet_tpu_torch.scripts.exp.eval --exp_dir samples/ \
        [--baseline_key baseline] [--vggish_ckpt vggish.pth] [--device cpu]

Writes `stats-<metric>.csv` (condition, mean, count, std with ddof 1, one
row per condition in sorted order) and `metrics-all.csv` (mel, frechet,
condition, file; one row per file pair), the columns and rows that the
JAX package's script writes with pandas, here with the `csv` module.
"""
from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np

from ... import config as cfglib
from ...audio import AudioSignal
from ...eval import FrechetAudioDistance, mel_spectrogram_loss


def _cell(x) -> str:
    """A CSV cell as pandas writes it: floats in full precision, NaN empty."""
    if isinstance(x, float):
        return "" if math.isnan(x) else repr(x)
    return str(x)


def _write_csv(path: Path, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([_cell(x) for x in row] for row in rows)


def evaluate(exp_dir: str, baseline_key: str = "baseline", audio_ext: str = ".wav",
             vggish_ckpt: str = None, device="cuda"):
    """Score every condition directory of `exp_dir` against
    `exp_dir/<baseline_key>`; returns the per-file metrics. With a
    torchvggish checkpoint the FAD embeds with VGGish on `device`, else
    with the log-mel default."""
    exp_dir = Path(exp_dir)
    if not exp_dir.exists():
        raise FileNotFoundError(f"exp_dir {exp_dir} does not exist")
    embedding_fn = None
    if vggish_ckpt:
        from ...vggish import VGGishEmbedder

        embedding_fn = VGGishEmbedder(vggish_ckpt, device=device)
    frechet = FrechetAudioDistance(embedding_fn=embedding_fn, audio_ext=audio_ext, verbose=True)

    conditions = [d.name for d in exp_dir.iterdir() if d.is_dir()]
    if baseline_key not in conditions:
        raise ValueError(f"baseline_key {baseline_key} not found in {exp_dir}")
    conditions.remove(baseline_key)
    print(f"Found {len(conditions)} conditions in {exp_dir}: {conditions}")

    baseline_dir = exp_dir / baseline_key
    baseline_files = sorted(baseline_dir.glob(f"*{audio_ext}"), key=lambda x: int(x.stem))

    metrics = []
    for condition in conditions:
        cond_dir = exp_dir / condition
        cond_files = sorted(cond_dir.glob(f"*{audio_ext}"), key=lambda x: int(x.stem))
        print(f"computing fad for {baseline_dir} and {cond_dir}")
        frechet_score = frechet.score(baseline_dir, cond_dir)

        num_files = min(len(baseline_files), len(cond_files))
        for b_file, c_file in zip(baseline_files[:num_files], cond_files[:num_files]):
            if b_file.stem != c_file.stem:
                raise ValueError(f"{b_file} and {c_file} are not the same excerpt")
            b_sig = AudioSignal(b_file)
            c_sig = AudioSignal(c_file)
            c_sig.resample(b_sig.sample_rate)
            c_sig.samples = c_sig.samples[..., : b_sig.length]

            # inpainting conditions: the conditioning context is trimmed off
            if "inpaint" in condition:
                ctx = int(float(condition.split("_")[-1]) * b_sig.sample_rate)
                c_sig.trim(ctx, ctx)
                b_sig = AudioSignal(b_sig.samples.copy(), b_sig.sample_rate).trim(ctx, ctx)

            metrics.append({"mel": mel_spectrogram_loss(b_sig, c_sig),
                            "frechet": frechet_score, "condition": condition,
                            "file": b_file.stem})

    for mk in [k for k in metrics[0] if k not in ("condition", "file")]:
        rows = []
        for condition in sorted({m["condition"] for m in metrics}):
            vals = np.array([m[mk] for m in metrics if m["condition"] == condition], np.float64)
            std = float(vals.std(ddof=1)) if len(vals) > 1 else float("nan")
            rows.append([condition, float(vals.mean()), len(vals), std])
        _write_csv(exp_dir / f"stats-{mk}.csv", ["condition", "mean", "count", "std"], rows)
    _write_csv(exp_dir / "metrics-all.csv", list(metrics[0]),
               [list(m.values()) for m in metrics])
    return metrics


def main(argv=None):
    args = cfglib.parse_args(argv)
    return evaluate(exp_dir=args.get("exp_dir"),
                    baseline_key=args.get("baseline_key", "baseline"),
                    audio_ext=args.get("audio_ext", ".wav"),
                    vggish_ckpt=args.get("vggish_ckpt"), device=args.get("device", "cuda"))


if __name__ == "__main__":
    main()
