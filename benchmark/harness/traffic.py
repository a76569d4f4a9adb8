"""The one generator that reads every traffic file.

A serving mix (`"kind": "serve"`) gives the arrivals (`"closed"`: a number
of clients, each sending its next request when the last returns) and the
request mix: clip lengths, presets, top-p values, variations, steps and the
temperature every request samples at. Every seed gets the same multiset of
sizes and settings in its own order, so that a seed changes which request
comes when and not how much work a run holds.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RequestSpec:
    rid: int
    client: int
    clip: int  # index into the run's clip pool
    clip_s: float
    preset: str
    top_p: Optional[float]
    seed: int


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                                        *stream]))


class ServeMix:
    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.seed = int(seed)
        self.clip_s: List[float] = [float(s) for s in traffic["clip_seconds"]]
        self.presets: List[str] = list(traffic["presets"])
        self.top_p: list = list(traffic["top_p"])
        self.variations = int(traffic["variations"])
        self.steps = int(traffic["sampling_steps"])
        self.temperature = float(traffic["temperature"])
        self.clips_per_length = int(traffic.get("clips_per_length", 4))
        arrival = traffic["arrival"]
        if arrival["process"] != "closed":
            raise ValueError(f"unknown arrival process {arrival['process']!r}")
        self.clients = int(arrival["clients"])

    def clip_pool(self, sr: int):
        """[(seconds, samples)]: clips_per_length clips of each length."""
        from .inputs import clip

        rng = _rng(self.seed, 1)
        return [(s, clip(rng, sr, s)) for s in self.clip_s for _ in range(self.clips_per_length)]

    def _spec(self, rid: int, client: int, rng, clip_s: float, preset: str,
              top_p) -> RequestSpec:
        k = self.clip_s.index(clip_s) * self.clips_per_length + int(
            rng.integers(self.clips_per_length))
        return RequestSpec(rid, client, k, clip_s, preset, top_p,
                           seed=int(rng.integers(1, 2 ** 31 - 1)))

    def closed(self, client: int, k: int) -> RequestSpec:
        """Client `client`'s k-th request; the clients cycle through the mix."""
        rng = _rng(self.seed, 2, client, k)
        i = k + client
        return self._spec(client * 1_000_000 + k, client, rng, self.clip_s[i % len(self.clip_s)],
                          self.presets[i % len(self.presets)], self.top_p[i % len(self.top_p)])


def train_pool(traffic: dict, seed: int, sr: int, hop: int) -> np.ndarray:
    """(pool_batches, batch, n, 1) float32 rows of noise, every row its own."""
    from .inputs import train_rows

    b, k = int(traffic["batch"]), int(traffic["pool_batches"])
    rows = train_rows(_rng(seed, 5), sr, hop, float(traffic["audio_seconds"]), b * k)
    return rows.reshape(k, b, *rows.shape[1:])


def step_seeds(seed: int, n: int) -> List[int]:
    """The generator seed of each training step, a stream drawn from the run's seed."""
    rng = _rng(seed, 6)
    return [int(x) for x in rng.integers(0, 2 ** 31 - 1, size=n)]
