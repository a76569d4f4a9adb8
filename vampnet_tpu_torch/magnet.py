"""MAGNeT text-to-music through the port (`MagnetInterface`): the T5-base
encoder and its projection, the MAGNeT LM's stage loop on doubled
classifier-free-guidance rows, and the EnCodec 32 kHz decoder. A sibling of
`Interface` (VampNet's), served by the same `VampEngine` (`MagnetRequest`,
`serve/engine.py`).

    iface = MagnetInterface.from_modules(T5Config(), t5_state, MagnetConfig(), lm_state,
                                         EncodecConfig(), codec_state, device="cuda")
    c = iface.encode_text(ids, mask)                  # (b, l, 1536)
    codes = iface.generate(c, frames=1500, row_keys=keys)
    audio = iface.decode(codes)                       # (b, 1, frames * 640)

`VampEngine(magnet=iface).submit(MagnetRequest(...))` batches requests.

The T5 encoder and the LM hold bf16 weights and run their products in bf16
(their residual streams and norms in fp32); the codec holds and computes
fp32 with TF32 off. While tracing (`profiling.py`)
`encode_text` records a `magnet.t5` span, each stage of `generate` a
`magnet.stage` span and `decode` an `encodec.decode` span.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from . import profiling
from .codec.encodec import EncodecConfig, EncodecDecoder
from .interface import _load
from .modules.magnet import MagnetConfig, MagnetLM, T5Config, T5Encoder
from .sampling.generate import MAGNET_SPAN, magnet_generate
from .util import resolve_device

# audiocraft's MAGNeT generation defaults for 30 s
DEFAULTS = dict(decoding_steps=(60, 10, 10, 10), top_p=0.9, temperature=3.0,
                max_cfg_coef=10.0, min_cfg_coef=1.0)


class MagnetInterface:
    def __init__(self, t5: T5Encoder, lm: MagnetLM, codec: EncodecDecoder,
                 text_bucket: int = 64):
        """`text_bucket`: a group's text is padded to its longest, rounded up
        to a multiple of this (cross-attention has no key mask, so the
        padding enters every output, and a request's must not depend on its
        batch-mates)."""
        self.t5, self.lm, self.codec = t5, lm, codec
        self.text_bucket = text_bucket
        self.device = next(lm.parameters()).device
        self.codec.decoder.lstm.flatten_parameters()

    @classmethod
    def from_modules(cls, t5_cfg: T5Config, t5_params: Mapping, lm_cfg: MagnetConfig,
                     lm_params: Mapping, codec_cfg: EncodecConfig, codec_params: Mapping,
                     text_bucket: int = 64, device="cuda") -> "MagnetInterface":
        """Build from configs and port state dicts: T5 and the LM stored in
        their compute dtype, the codec fp32."""
        device = resolve_device(device)
        t5 = _load(T5Encoder(t5_cfg, device="meta"), t5_params, device, t5_cfg.dtype)
        lm = _load(MagnetLM(lm_cfg, device="meta"), lm_params, device, lm_cfg.dtype)
        codec = _load(EncodecDecoder(codec_cfg, device="meta"), codec_params, device,
                      torch.float32)
        return cls(t5, lm, codec, text_bucket)

    @property
    def sample_rate(self) -> int:
        return self.codec.config.sample_rate

    def frames(self, seconds: float) -> int:
        """Codec frames of `seconds` of audio, rounded up to whole spans."""
        n = math.ceil(seconds * self.sample_rate / self.codec.config.hop_length)
        return -(-n // MAGNET_SPAN) * MAGNET_SPAN

    def text_len(self, longest: int) -> int:
        return -(-max(longest, 1) // self.text_bucket) * self.text_bucket

    @torch.inference_mode()
    def encode_text(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids, mask (b, l) -> the conditioning c (b, l, dim): T5, then
        output_proj, zero on the padding."""
        with profiling.span("magnet.t5", rows=ids.shape[0], tokens=ids.shape[1]):
            return self.t5(ids.to(self.device), mask.to(self.device))

    @torch.inference_mode()
    def generate(self, c: torch.Tensor, frames: int, row_keys: torch.Tensor,
                 **knobs) -> torch.Tensor:
        """The stage loop (`magnet_generate`) for b rows of conditioning c
        (b, l, dim), CFG against an all-zero c; returns codes (b, n_q, frames).
        `knobs` override `DEFAULTS`."""
        cfg = self.lm.config
        b = c.shape[0]
        kv = self.lm.cross_kv(torch.cat([c, torch.zeros_like(c)]))
        opts = {**DEFAULTS, **knobs}
        return magnet_generate(
            lambda codes, stage: self.lm(codes, stage, kv), b, cfg.n_q, frames, cfg.mask_id,
            row_keys.to(self.device), **opts)

    @torch.inference_mode()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_q, frames) -> audio (b, 1, frames * hop) fp32."""
        with profiling.span("encodec.decode", rows=codes.shape[0], frames=codes.shape[-1]):
            return self.codec(codes.to(self.device))


def text_batch(texts, length: int, device: Optional[torch.device] = None):
    """Lists of T5 ids -> (ids, mask) (b, length) int64, zero-padded."""
    ids = torch.zeros((len(texts), length), dtype=torch.int64)
    mask = torch.zeros((len(texts), length), dtype=torch.int64)
    for i, t in enumerate(texts):
        ids[i, :len(t)] = torch.as_tensor(t, dtype=torch.int64)
        mask[i, :len(t)] = 1
    return (ids, mask) if device is None else (ids.to(device), mask.to(device))
