"""Serving entry point (counterpart of `vampnet_tpu/interface.py`):
`Interface.from_modules`, `quantize`, `s2t`, `_preprocess` and `vamp_e2e`.

`vamp_e2e` runs one vamp request: host preprocess -> codec encode -> mask
build -> coarse MaskGIT over chunk rows -> c2f MaskGIT -> codec decode. It
runs eagerly; every attention layer of every step goes through the attention
kernel and every step through the sampler kernel when the Interface lives on
the card. Randomness comes from one `torch.Generator` seeded per request; the
port does not reproduce `jax.random`'s bits, so the JAX package and the port
agree token for token only where no random draw decides anything.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import mask as pmask
from .audio import AudioSignal
from .codec import LAC, CodecConfig
from .modules import LMConfig, VampNetLM
from .modules.quantize import quantize_lm_state_dict
from .modules.transformer import position_bias_from_params
from .sampling.generate import generate
from .util import resolve_device


def _load(module: nn.Module, state: Mapping, device: torch.device,
          dtype: torch.dtype) -> nn.Module:
    """Materialise a module built on the meta device on `device`, with float
    parameters in `dtype`, from a state dict of tensors or numpy arrays.
    Buffers keep their dtype: an int8 LM's fp32 weight scales stay fp32, as
    the JAX package keeps them."""
    module = module.to_empty(device=device)
    for p in module.parameters():
        p.data = p.data.to(dtype)
    state = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
             for k, v in state.items()}
    module.load_state_dict(state, strict=True)
    return module.requires_grad_(False).eval()


class Interface:
    def __init__(self, codec: LAC, coarse: VampNetLM, c2f: Optional[VampNetLM],
                 coarse_chunk_size_s: float = 10, coarse2fine_chunk_size_s: float = 3):
        self.codec = codec
        self.codec_config: CodecConfig = codec.config
        self.coarse = coarse
        self.c2f = c2f
        self.coarse_chunk_size_s = coarse_chunk_size_s
        self.c2f_chunk_size_s = coarse2fine_chunk_size_s
        self.device = next(codec.parameters()).device
        self.loudness = -24.0
        self.codebooks = codec.codebook_tables()  # (n_cb, vocab, codebook_dim)

    @classmethod
    def from_modules(cls, codec_cfg: CodecConfig, codec_params: Mapping,
                     coarse_cfg: LMConfig, coarse_params: Mapping,
                     c2f_cfg: Optional[LMConfig] = None, c2f_params: Optional[Mapping] = None,
                     coarse_chunk_size_s: float = 10, coarse2fine_chunk_size_s: float = 3,
                     device="cuda") -> "Interface":
        """Build from configs and port state dicts (see `convert.py` for the
        bridge from JAX param trees). LM weights are stored bf16, as the
        JAX package stores them for inference; the codec stays fp32."""
        device = resolve_device(device)
        codec = _load(LAC(codec_cfg, device="meta"), codec_params, device, torch.float32)
        coarse = _load(VampNetLM(coarse_cfg, device="meta"), coarse_params, device,
                       torch.bfloat16)
        c2f = None
        if c2f_cfg is not None:
            c2f = _load(VampNetLM(c2f_cfg, device="meta"), c2f_params, device,
                        torch.bfloat16)
        return cls(codec, coarse, c2f, coarse_chunk_size_s, coarse2fine_chunk_size_s)

    def quantize(self) -> "Interface":
        """Post-training int8 (w8a8) on both LMs, an opt-in for serving: the
        attention and FFN projections switch to int8 weights with per-channel
        fp32 scales and per-row activation quantization (`w8a8_matmul`); the
        embeddings and the classifier stay bf16. Tokens may differ slightly
        from the bf16 path. The weights are quantized from the bf16-stored
        ones, as the JAX package does, and the bf16 kernels they replace are
        dropped. Calling it again does nothing."""
        if self.coarse.config.quantization == "int8":
            return self
        for name in ("coarse", "c2f"):
            lm = getattr(self, name)
            if lm is None:
                continue
            cfg = dataclasses.replace(lm.config, quantization="int8")
            state = quantize_lm_state_dict(lm.state_dict())
            setattr(self, name, None)
            del lm
            setattr(self, name, _load(VampNetLM(cfg, device="meta"), state, self.device,
                                      torch.bfloat16))
            del state
        return self

    def s2t(self, seconds: float) -> int:
        """seconds -> tokens."""
        sr, hop = self.codec_config.sample_rate, self.codec_config.hop_length
        return math.ceil(seconds * sr / hop)

    def _preprocess(self, signal: AudioSignal) -> AudioSignal:
        """resample -> mono -> -24 LUFS -> peak cap -> pad to a hop multiple."""
        signal = (
            signal.clone()
            .resample(self.codec_config.sample_rate)
            .to_mono()
            .normalize(self.loudness)
            .ensure_max_of_audio(1.0)
        )
        pad = (-signal.length) % self.codec_config.hop_length
        if pad:
            signal.zero_pad(0, pad)
        return signal

    @torch.inference_mode()
    def vamp_e2e(
        self,
        sig: AudioSignal,
        batch_size: int = 2,
        seed: Optional[int] = None,
        rand_mask_intensity: float = 1.0,
        prefix_s: float = 0.0,
        suffix_s: float = 0.0,
        periodic_prompt: int = 7,
        periodic_prompt_width: int = 1,
        _dropout: float = 0.0,
        upper_codebook_mask: int = 3,
        _sampling_steps: int = 12,
        c2f_steps: int = 2,
        temperature: float = 1.0,
        mask_temperature: float = 10.5,
        typical_filtering: bool = True,
        typical_mass: float = 0.15,
        typical_min_tokens: int = 64,
        top_p: Optional[float] = None,
        sample_cutoff: float = 1.0,
        transfer_dtype: str = "float32",
    ) -> AudioSignal:
        """One vamp request, encode to decode, as `vampnet_tpu`'s `vamp_e2e`.

        `transfer_dtype="int16"` moves the waveform between host and device
        as 16-bit PCM both ways: the input is hard-clipped to [-1, 1] and
        quantized to 1/32767 before encode, the output likewise. Only finite
        input is supported on that path (NaN has no PCM value)."""
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype must be float32 or int16, got {transfer_dtype}")
        dev = self.device
        sig = self._preprocess(sig)
        audio_np = sig.samples.transpose(0, 2, 1)  # (b, t, 1)
        if transfer_dtype == "int16":
            audio_np = np.round(np.clip(audio_np, -1.0, 1.0) * 32767.0).astype(np.int16)
        audio = torch.from_numpy(np.ascontiguousarray(audio_np)).to(dev)
        if audio.dtype == torch.int16:
            audio = audio.to(torch.float32) * (1.0 / 32767.0)
        hop = self.codec_config.hop_length
        t_tokens = audio.shape[1] // hop
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) if seed is not None else int(np.random.randint(0, 2**31 - 1)))

        codes = self.codec.encode(audio)[:, :, :t_tokens]

        # ---- mask ----
        m = pmask.linear_random(gen, codes, rand_mask_intensity)
        m = pmask.mask_and(m, pmask.inpaint(codes, self.s2t(prefix_s), self.s2t(suffix_s)))
        m = pmask.mask_and(m, pmask.periodic_mask(
            codes, periodic_prompt, periodic_prompt_width, random_roll=True, generator=gen))
        m = pmask.dropout(gen, m, float(_dropout))
        m = pmask.codebook_mask(m, int(upper_codebook_mask))

        # ---- batch expand + coarse chunks as batch rows ----
        z = codes.expand((batch_size,) + codes.shape[1:]).contiguous()
        m = m.expand((batch_size,) + m.shape[1:]).contiguous()
        coarse, c2f = self.coarse, self.c2f
        mask_token = coarse.mask_token
        n_coarse = coarse.config.n_codebooks
        chunk_len = self.s2t(self.coarse_chunk_size_s)
        n_chunks = math.ceil(t_tokens / chunk_len)
        pad = n_chunks * chunk_len - t_tokens

        def to_chunks(x, n_cb, L, nc):
            x = x.reshape(batch_size, n_cb, nc, L).permute(2, 0, 1, 3)
            return x.reshape(nc * batch_size, n_cb, L)

        def from_chunks(x, n_cb, L, nc):
            x = x.reshape(nc, batch_size, n_cb, L).permute(1, 2, 0, 3)
            return x.reshape(batch_size, n_cb, nc * L)[:, :, :t_tokens]

        # chunk-edge pinning for seam continuity: a chunk's first and last
        # steps are kept whenever any step of that chunk is kept
        cm_un = m[:, :n_coarse].clone()
        chunked = F.pad(cm_un, (0, pad), value=1).reshape(batch_size, n_coarse, n_chunks, chunk_len)
        has_zero = (chunked == 0).any(dim=3).any(dim=1).any(dim=0)
        pin = torch.where(has_zero, 0, 1).to(cm_un.dtype)
        lo_idx = torch.tensor([i * chunk_len for i in range(n_chunks)], device=dev)
        hi_idx = torch.tensor([min(t_tokens, (i + 1) * chunk_len) - 1 for i in range(n_chunks)],
                              device=dev)
        cm_un[:, :, lo_idx] = torch.minimum(cm_un[:, :, lo_idx], pin)
        cm_un[:, :, hi_idx] = torch.minimum(cm_un[:, :, hi_idx], pin)

        cz_c = to_chunks(F.pad(z[:, :n_coarse], (0, pad)), n_coarse, chunk_len, n_chunks)
        cm_c = to_chunks(F.pad(cm_un, (0, pad), value=1), n_coarse, chunk_len, n_chunks)
        z_masked = torch.where(cm_c.bool(), mask_token, cz_c)

        # the T5 bias depends only on the chunk length: built once per request
        coarse_bias = position_bias_from_params(coarse, chunk_len)
        cbs = self.codebooks
        cv = generate(
            lambda zm: coarse.forward_codes(zm, cbs[:n_coarse], position_bias=coarse_bias),
            z_masked, cm_c, mask_token, gen,
            sampling_steps=int(_sampling_steps), temperature=temperature,
            mask_temperature=mask_temperature, typical_filtering=bool(typical_filtering),
            typical_mass=float(typical_mass), typical_min_tokens=int(typical_min_tokens),
            top_p=top_p, sample_cutoff=sample_cutoff,
        )
        zv = from_chunks(cv, n_coarse, chunk_len, n_chunks)

        # ---- c2f ----
        if c2f is not None:
            n_cb = c2f.config.n_codebooks
            ncc = c2f.config.n_conditioning_codebooks
            f_len = self.s2t(self.c2f_chunk_size_s)
            n_chunks_f = math.ceil(t_tokens / f_len)
            pad_f = n_chunks_f * f_len - t_tokens
            zf = F.pad(torch.cat([zv, z[:, n_coarse:]], dim=1), (0, pad_f))
            mf = F.pad(pmask.codebook_unmask(m, ncc), (0, pad_f), value=1)
            zf_c = to_chunks(zf, n_cb, f_len, n_chunks_f)
            mf_c = to_chunks(mf, n_cb, f_len, n_chunks_f)
            zf_masked = torch.where(mf_c.bool(), mask_token, zf_c)
            c2f_bias = position_bias_from_params(c2f, f_len)
            fv = generate(
                lambda zm: c2f.forward_codes(zm, cbs[:n_cb], position_bias=c2f_bias),
                zf_masked, mf_c, mask_token, gen, n_conditioning_codebooks=ncc,
                sampling_steps=int(c2f_steps), temperature=temperature,
                mask_temperature=mask_temperature, typical_filtering=True,
                typical_mass=float(typical_mass), typical_min_tokens=int(typical_min_tokens),
                sample_cutoff=sample_cutoff,
            )
            zv = from_chunks(fv, n_cb, f_len, n_chunks_f)

        # ---- decode ----
        z0 = torch.where(zv == mask_token, 0, zv)
        wav = self.codec.decode_codes(z0)[:, : t_tokens * hop]
        if transfer_dtype == "int16":
            wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        out = wav.cpu().numpy()
        if out.dtype == np.int16:
            out = out.astype(np.float32) * (1.0 / 32767.0)
        return AudioSignal(out.transpose(0, 2, 1), self.codec_config.sample_rate)
