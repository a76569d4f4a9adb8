"""Cut one long audio file into half-overlapping windows (counterpart of the
repository's `scripts/utils/split_long_audio_file.py`), written to a
folder named after the file.

    python -m vampnet_tpu_torch.scripts.utils.split_long_audio_file --file long.wav \
        --max_chunk_size_s 600
"""
from __future__ import annotations

from pathlib import Path

from ... import config as cfglib
from ...audio import AudioSignal


def split_long_audio_file(file: str, max_chunk_size_s: int = 60 * 10):
    file = Path(file)
    output_dir = file.parent / file.stem
    output_dir.mkdir(exist_ok=True)

    sig = AudioSignal(file)
    window = int(max_chunk_size_s * sig.sample_rate)
    hop = window // 2
    i = 0
    for start in range(0, max(1, sig.length - hop), hop):
        chunk = sig.samples[:, :, start: start + window]
        if chunk.shape[-1] == 0:
            break
        AudioSignal(chunk.copy(), sig.sample_rate).write(output_dir / f"{i}.wav")
        i += 1
    print(f"wrote {i} files to {output_dir}")
    return output_dir


if __name__ == "__main__":
    args = cfglib.parse_args()
    split_long_audio_file(file=args["file"],
                          max_chunk_size_s=int(args.get("max_chunk_size_s", 600)))
