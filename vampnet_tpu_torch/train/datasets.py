"""Audio data pipeline (counterpart of `vampnet_tpu/train/datasets.py`;
upstream uses audiotools' AudioDataset and AudioLoader).

Host-side: scan source directories for audio files, draw fixed-duration
excerpts above a loudness cutoff (numpy `default_rng(idx)` per item, so item
idx is the same excerpt in both packages), apply the train transform
(-24 LUFS, then rescale), and prefetch batches on a thread pool so the step
never waits on IO. Batches are fixed-shape numpy arrays (b, t, 1) fp32 on
the host; the loop moves each to the card in one pinned, non-blocking copy.
"""
from __future__ import annotations

import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..audio.signal import AudioSignal, _loudness_lufs

AUDIO_EXTS = {".wav", ".flac", ".mp3", ".ogg", ".aif", ".aiff"}


def find_audio(sources: Sequence[str], relative_path: str = "") -> List[Path]:
    files: List[Path] = []
    for src in sources:
        p = Path(relative_path) / src if relative_path else Path(src)
        if p.is_file() and p.suffix.lower() in AUDIO_EXTS:
            files.append(p)
        elif p.is_dir():
            files.extend(
                sorted(q for q in p.rglob("*") if q.suffix.lower() in AUDIO_EXTS)
            )
    return files


class AudioLoader:
    """File discovery and excerpt drawing (audiotools' AudioLoader surface)."""

    def __init__(
        self,
        sources: Optional[Sequence[str]] = None,
        relative_path: str = "",
        shuffle: bool = True,
    ):
        self.sources = list(sources or [])
        self.relative_path = relative_path
        self.shuffle = shuffle
        self.files = find_audio(self.sources, relative_path)

    def __len__(self) -> int:
        return len(self.files)

    def load_excerpt(
        self, idx: int, duration: float, sample_rate: int, rng: np.random.Generator
    ) -> AudioSignal:
        path = self.files[idx % len(self.files)]
        sig = AudioSignal(path)
        sig.resample(sample_rate).to_mono()
        want = int(duration * sample_rate)
        if sig.length >= want:
            off = int(rng.integers(0, sig.length - want + 1))
            sig.samples = sig.samples[:, :, off : off + want]
        else:
            sig.zero_pad(0, want - sig.length)
        return sig


class AudioDataset:
    """Random-excerpt dataset with loudness gating (audiotools'
    AudioDataset surface)."""

    def __init__(
        self,
        loader: AudioLoader,
        sample_rate: int,
        duration: float = 10.0,
        loudness_cutoff: float = -30.0,
        n_examples: int = 10_000_000,
        without_replacement: bool = True,
        transform=None,
        max_retries: int = 5,
    ):
        if len(loader) == 0:
            raise ValueError(f"no audio found in {loader.sources}")
        self.loader = loader
        self.sample_rate = sample_rate
        self.duration = duration
        self.loudness_cutoff = loudness_cutoff
        self.n_examples = n_examples
        self.without_replacement = without_replacement
        self.transform = transform or default_transform
        self.max_retries = max_retries

    def __len__(self) -> int:
        return self.n_examples

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(idx)
        file_idx = (
            idx if self.without_replacement else int(rng.integers(0, len(self.loader)))
        )
        sig = None
        for _ in range(self.max_retries):
            sig = self.loader.load_excerpt(file_idx, self.duration, self.sample_rate, rng)
            loud = _loudness_lufs(sig.samples, sig.sample_rate)[0]
            if loud >= self.loudness_cutoff:
                break
            file_idx = int(rng.integers(0, len(self.loader)))
        return {"signal": sig, "idx": idx}


def default_transform(sig: AudioSignal) -> AudioSignal:
    """VolumeNorm(-24 LUFS), then RescaleAudio (upstream's train transform)."""
    sig = sig.clone().normalize(-24.0)
    return sig.ensure_max_of_audio(1.0)


class BatchLoader:
    """Threaded prefetching batch iterator -> (b, t, 1) float32 numpy.

    `start_idx` fast-forwards for checkpoint resume.

    `shard=(pid, n_proc)` yields only this process's rows of each GLOBAL
    batch (rows pid*b/n .. (pid+1)*b/n): batch indices stay aligned with the
    one-process run while every process loads disjoint data (upstream's
    DistributedSampler).
    """

    def __init__(
        self,
        dataset: AudioDataset,
        batch_size: int,
        num_workers: int = 4,
        start_idx: int = 0,
        prefetch: int = 4,
        shard: tuple = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.start_idx = start_idx
        self.prefetch = prefetch
        pid, n_proc = shard
        if batch_size % n_proc != 0 or not (0 <= pid < n_proc):
            raise ValueError(f"bad shard {shard} for batch_size {batch_size}")
        self.shard = (pid, n_proc)

    def __iter__(self) -> Iterator[np.ndarray]:
        # Workers build slabs concurrently but the consumer emits them in
        # GLOBAL-INDEX order (a reassembly window, not a completion-order
        # queue): batch k is always the same rows in every run and on every
        # shard, which resume and `shard=` depend on.
        stop = threading.Event()
        cond = threading.Condition()
        ready: dict = {}
        next_claim = [self.start_idx]  # next slab a worker builds
        next_emit = [self.start_idx]  # next slab the consumer yields

        pid, n_proc = self.shard
        local_bs = self.batch_size // n_proc
        window = max(1, self.prefetch) * self.batch_size

        errors: list = []

        def worker():
            try:
                build()
            except BaseException as e:  # re-raised in the consumer
                with cond:
                    errors.append(e)
                    cond.notify_all()

        def build():
            while not stop.is_set():
                with cond:
                    lo_global = next_claim[0]
                    if lo_global >= len(self.dataset):
                        cond.notify_all()
                        return
                    next_claim[0] += self.batch_size
                lo = lo_global + pid * local_bs
                sigs = []
                for i in range(lo, lo + local_bs):
                    item = self.dataset[i % len(self.dataset)]
                    sigs.append(self.dataset.transform(item["signal"]))
                want = int(self.dataset.duration * self.dataset.sample_rate)
                batch = np.stack(
                    [
                        np.pad(s.samples[0, 0, :want], (0, max(0, want - s.length)))
                        for s in sigs
                    ]
                )[..., None].astype(np.float32)
                with cond:
                    # bound memory: don't run further than `prefetch` slabs
                    # ahead of the consumer (the slab == next_emit always
                    # passes, so the lowest outstanding slab never blocks)
                    while (
                        not stop.is_set()
                        and lo_global >= next_emit[0] + window
                    ):
                        cond.wait(timeout=1)
                    if stop.is_set():
                        return
                    ready[lo_global] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while next_emit[0] < len(self.dataset):
                with cond:
                    while next_emit[0] not in ready and not errors:
                        if not any(t.is_alive() for t in threads):
                            break
                        cond.wait(timeout=1)
                    if errors:
                        raise RuntimeError("a BatchLoader worker failed") from errors[0]
                    if next_emit[0] not in ready:
                        break
                    batch = ready.pop(next_emit[0])
                    next_emit[0] += self.batch_size
                    cond.notify_all()
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()
