"""Serving entry point (counterpart of `vampnet_tpu/interface.py`):
`Interface.from_checkpoints` (the JAX `Interface(...)`: `.vtpu` or upstream
`.pth` files, LoRA-only overlays), `default`, `load_finetuned` and `reload`
(the local models directory, `registry.py`), `Interface.from_modules`,
`quantize`, the staged API (`encode`, `build_mask` with the onset mask,
`set_chunk_size`, `vamp` with `coarse_vamp` and `coarse_to_fine`, `top_k`
and `cfg_guidance` included, `decode`), the beat masks (`make_beat_mask`,
`snap_to_beats`, from a wavebeat checkpoint's tracker) and the one-call
`vamp_e2e`.

The staged API is the sequence the JAX package's Gradio app, web app and
token telephone run: encode -> build_mask -> set_chunk_size -> vamp ->
decode. `vamp_e2e` runs the same stages in one call: host preprocess ->
codec encode -> mask build -> coarse MaskGIT over chunk rows -> c2f MaskGIT
-> codec decode. Both run eagerly; every attention layer of every step goes
through the attention kernels and every step through the sampler kernel when
the Interface lives on the card. The coarse chunk length is whatever
`set_chunk_size` made it: past 1024 tokens (about 11.9 s at 44.1 kHz, hop
512) the attention takes the long forward (K9).

Randomness comes from `torch.Generator`s: one per request in `vamp_e2e`;
in the staged API one per stage, seeded as the JAX package seeds its keys
(`build_mask` from its seed, each `coarse_vamp` and `coarse_to_fine` of a
`vamp` from sub-seeds that `np.random.default_rng(seed)` draws). A seed
array of length b given to `coarse_vamp` or `coarse_to_fine` gives per-row
keys instead, as the JAX package's does: seed s is the key (0, s mod 2^32),
chunk row c * b + j takes `fold_in_rows(keys[j], offset + c)` where a
request spans several chunk rows, and each row then draws from its own
streams (`sampling/sample.py`), so a request's tokens depend only on its own
seed. The serving engine (`serve/engine.py`) relies on that. The port does
not reproduce `jax.random`'s bits, so the JAX package and the port agree
token for token only where no random draw decides anything.

Several devices (`shard`, `shard_pipeline`; `parallel/`): one process holds
a mesh and drives all of its devices, as the JAX package's one controller
does. A mesh may repeat a device (`["cuda:0"] * 4`, `["cpu"] * 8`): each
sharded path then runs on one device, every kernel at its sharded shapes.
  * `shard(tp=, mesh=)`: each LM's layers split Megatron-style over the tp
    axis of a ("dp", "tp") mesh (`TensorParallelStack`) and replicated over
    dp; a batch whose rows divide by dp splits over the dp groups
    (`parallel/placement.py`). The logits of every forward meet on the
    mesh's first device, where the MaskGIT loop samples them (K10) as it
    does unsharded.
  * `shard(sp=)`: the coarse LM's layers as a ring-attention `RingStack`
    over an ("sp",) mesh, and `coarse_vamp` generates the whole sequence in
    one pass (`chunked=False`, the default there), padded to `sp_pad_len`;
    the windowed paths and the c2f LM run unplaced.
  * `shard_pipeline()`: coarse on one slice of the devices, c2f and the
    decode codec on the rest; each stage runs on its slice's first device
    and hands its codes back to the Interface's device.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import convert
from . import mask as pmask
from .audio import AudioSignal
from .checkpoints import load_codec, load_lm
from .codec import LAC, CodecConfig
from .modules import LMConfig, VampNetLM
from .modules.quantize import quantize_lm_state_dict
from .modules.transformer import position_bias_from_params
from .parallel.placement import InterfacePlacement, Placement
from .sampling.generate import generate
from .sampling.sample import fold_in_rows
from .util import resolve_device, to_device

# the JAX package's default pipeline split: about 3 coarse devices to 1 c2f
PIPELINE_COARSE_SHARE = 0.75


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


def _lm_from_file(path, lora_path, device: torch.device) -> VampNetLM:
    """An LM checkpoint (and a LoRA-only overlay) on `device`, weights in
    bf16."""
    cfg, tree = load_lm(path, lora_path)
    return _load(VampNetLM(cfg, device="meta"), convert.lm_state_dict_from_jax(tree, cfg),
                 device, torch.bfloat16)


# the keyword arguments of a vamp that coarse_to_fine also takes (the JAX
# package's `vamp`)
_C2F_KWARGS = ("temperature", "mask_temperature", "typical_mass", "typical_min_tokens",
               "sample_cutoff")


def _keys_from_seeds(seeds, device) -> torch.Tensor:
    """Seeds (b,) -> per-row keys (b, 2) int64: seed s is (0, s mod 2^32),
    the words of `jax.random.PRNGKey(s)`."""
    s = np.asarray(seeds, dtype=np.int64).reshape(-1) & 0xFFFFFFFF
    return to_device(np.stack([np.zeros_like(s), s], axis=1), device)


def _expand_row_keys(keys: torch.Tensor, n_rep: int, offset: int = 0) -> torch.Tensor:
    """(b, 2) per-request keys -> (n_rep * b, 2) per-chunk-row keys, row
    c * b + j = fold_in_rows(keys[j], offset + c). `offset` is the global
    index of the first chunk, so a request streamed group by group draws
    what the ungrouped run draws."""
    return torch.cat([fold_in_rows(keys, offset + c) for c in range(n_rep)], dim=0)


class Interface:
    """The codec and the two LMs on one device. Each LM carries its chunk
    length in seconds as `chunk_size_s`, where the JAX package's `_LoadedLM`
    keeps it; `set_chunk_size` changes the coarse one, and the staged API
    and `vamp_e2e` both read them."""

    def __init__(self, codec: LAC, coarse: VampNetLM, c2f: Optional[VampNetLM],
                 coarse_chunk_size_s: float = 10, coarse2fine_chunk_size_s: float = 3):
        self.codec = codec
        self.codec_config: CodecConfig = codec.config
        self.coarse = coarse
        self.c2f = c2f
        coarse.chunk_size_s = coarse_chunk_size_s
        if c2f is not None:
            c2f.chunk_size_s = coarse2fine_chunk_size_s
        self.device = next(codec.parameters()).device
        self.loudness = -24.0
        self.codebooks = codec.codebook_tables()  # (n_cb, vocab, codebook_dim)
        # a `beats.WaveBeat` where a wavebeat checkpoint was given; without
        # one the apps' "follow beat" presets skip the beat mask, as in JAX
        self.beat_tracker = None
        # the files the models came from (`from_checkpoints`, `reload`)
        self.codec_path: Optional[Path] = None
        self.coarse_path: Optional[Path] = None
        self.c2f_path: Optional[Path] = None
        # where the models run (`shard`, `shard_pipeline`), set whole
        self.placement = InterfacePlacement()

    @classmethod
    def from_checkpoints(
        cls,
        coarse_ckpt: Optional[str] = None,
        coarse_lora_ckpt: Optional[str] = None,
        coarse2fine_ckpt: Optional[str] = None,
        coarse2fine_lora_ckpt: Optional[str] = None,
        codec_ckpt: Optional[str] = None,
        wavebeat_ckpt: Optional[str] = None,
        device="cuda",
        coarse_chunk_size_s: float = 10,
        coarse2fine_chunk_size_s: float = 3,
        codec_overrides: Optional[Dict[str, Any]] = None,
    ) -> "Interface":
        """The JAX package's file-based `Interface(...)`: the codec and the
        LMs from `.vtpu` or upstream `.pth` files, each LM with an optional
        LoRA-only overlay. LM weights are stored bf16, the codec fp32, as in
        `from_modules`. `codec_overrides` sets the codec's runtime options
        (`conv_impl`, `compute_dtype`, `decoder_compute_dtype`): they change
        the schedule, never the weights, so any saved codec takes them."""
        device = resolve_device(device)
        if codec_ckpt is None or coarse_ckpt is None:
            raise ValueError("from_checkpoints needs a codec and a coarse checkpoint")
        codec_cfg, codec_tree = load_codec(codec_ckpt)
        codec_cfg = dataclasses.replace(codec_cfg, **(codec_overrides or {}))
        codec = _load(LAC(codec_cfg, device="meta"),
                      convert.codec_state_dict_from_jax(codec_tree, codec_cfg), device,
                      torch.float32)
        del codec_tree
        coarse = _lm_from_file(coarse_ckpt, coarse_lora_ckpt, device)
        c2f = None
        if coarse2fine_ckpt is not None:
            c2f = _lm_from_file(coarse2fine_ckpt, coarse2fine_lora_ckpt, device)
        self = cls(codec, coarse, c2f, coarse_chunk_size_s, coarse2fine_chunk_size_s)
        self.codec_path, self.coarse_path = Path(codec_ckpt), Path(coarse_ckpt)
        self.c2f_path = Path(coarse2fine_ckpt) if coarse2fine_ckpt is not None else None
        self._set_beat_tracker(wavebeat_ckpt)
        return self

    def _set_beat_tracker(self, wavebeat_ckpt) -> None:
        if wavebeat_ckpt is not None:
            from .beats import WaveBeat

            self.beat_tracker = WaveBeat(wavebeat_ckpt, device=self.device)

    @classmethod
    def default(cls, device="cuda") -> "Interface":
        """The models directory's codec, coarse and c2f checkpoints
        (`registry.py`), and its `wavebeat.vtpu` or `wavebeat.pth` where
        one is there."""
        from .registry import MODELS_DIR, download_codec, download_default

        codec_path = download_codec()
        coarse_path, c2f_path = download_default()
        wavebeat = next((p for p in (MODELS_DIR / "wavebeat.vtpu", MODELS_DIR / "wavebeat.pth")
                         if p.exists()), None)
        return cls.from_checkpoints(coarse_ckpt=coarse_path, coarse2fine_ckpt=c2f_path,
                                    codec_ckpt=codec_path, device=device,
                                    wavebeat_ckpt=str(wavebeat) if wavebeat else None)

    @classmethod
    def available_models(cls):
        """The fine-tunes in the models directory, then "default"."""
        from .registry import list_finetuned

        return list_finetuned() + ["default"]

    def load_finetuned(self, name: str):
        """Swap in the fine-tune `name` (or "default") from the models
        directory."""
        if name not in self.available_models():
            raise ValueError(f"{name} is not a valid model name: {self.available_models()}")
        from .registry import download_default, download_finetuned

        if name == "default":
            coarse_path, c2f_path = download_default()
        else:
            coarse_path, c2f_path = download_finetuned(name)
        self.reload(coarse_ckpt=coarse_path, c2f_ckpt=c2f_path)

    def reload(self, coarse_ckpt: Optional[str] = None, c2f_ckpt: Optional[str] = None):
        """Swap LM checkpoints in. A path equal to the loaded one loads
        nothing. A swapped LM keeps the chunk size and takes its file's
        config, so after `quantize()` it is bf16 again, as in the JAX
        package. A swapped LM arrives unplaced: a `shard(sp=)` is left, and
        a pipeline placement is dropped (call `shard_pipeline()` again)."""
        swapped = set()
        if coarse_ckpt is not None and self.coarse_path != Path(coarse_ckpt):
            lm = _lm_from_file(coarse_ckpt, None, self.device)
            lm.chunk_size_s = self.coarse.chunk_size_s
            self.coarse, self.coarse_path = lm, Path(coarse_ckpt)
            swapped.add("coarse")
        if c2f_ckpt is not None and self.c2f_path != Path(c2f_ckpt):
            lm = _lm_from_file(c2f_ckpt, None, self.device)
            lm.chunk_size_s = self.c2f.chunk_size_s if self.c2f is not None else 3
            self.c2f, self.c2f_path = lm, Path(c2f_ckpt)
            swapped.add("c2f")
        place = self.placement
        kept = {k: p for k, p in place.lms.items() if k not in swapped}
        if len(kept) < len(place.lms) and (place.pipeline or place.sp > 1):
            # a pipeline or sp placement that lost its stage is left rather
            # than run one stage off its slice; shard() places again
            self.placement = InterfacePlacement()
        else:
            self.placement = dataclasses.replace(place, lms=kept)

    @classmethod
    def from_modules(cls, codec_cfg: CodecConfig, codec_params: Mapping,
                     coarse_cfg: LMConfig, coarse_params: Mapping,
                     c2f_cfg: Optional[LMConfig] = None, c2f_params: Optional[Mapping] = None,
                     coarse_chunk_size_s: float = 10, coarse2fine_chunk_size_s: float = 3,
                     wavebeat_ckpt: Optional[str] = None, device="cuda") -> "Interface":
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
        self = cls(codec, coarse, c2f, coarse_chunk_size_s, coarse2fine_chunk_size_s)
        self._set_beat_tracker(wavebeat_ckpt)
        return self

    def quantize(self) -> "Interface":
        """Post-training int8 (w8a8) on both LMs, an opt-in for serving: the
        attention and FFN projections switch to int8 weights with per-channel
        fp32 scales and per-row activation quantization (`w8a8_matmul`); the
        embeddings and the classifier stay bf16. Tokens may differ slightly
        from the bf16 path. The weights are quantized from the bf16-stored
        ones, as the JAX package does, and the bf16 kernels they replace are
        dropped. An LM already int8 is left as it is. Call it before
        `shard()` or `shard_pipeline()`: it leaves the Interface unplaced (a
        `shard(sp=)` is left, a pipeline dropped)."""
        self.placement = InterfacePlacement()
        for name in ("coarse", "c2f"):
            lm = getattr(self, name)
            if lm is None or lm.config.quantization == "int8":
                continue
            cfg = dataclasses.replace(lm.config, quantization="int8")
            state = quantize_lm_state_dict(lm.state_dict())
            chunk_size_s = lm.chunk_size_s
            setattr(self, name, None)
            del lm
            lm = _load(VampNetLM(cfg, device="meta"), state, self.device, torch.bfloat16)
            lm.chunk_size_s = chunk_size_s
            setattr(self, name, lm)
            del state
        return self

    # ---------- several devices ----------

    def _placement(self, lm, whole_sequence: bool = False):
        """The placement a MaskGIT call of `lm` runs under, or None. An sp
        placement serves the chunk-free coarse path (`whole_sequence`)
        alone, so under sp every windowed call runs unplaced; any other
        placement serves the windows."""
        if (self.placement.sp > 1) != whole_sequence:
            return None
        return self.placement.of(lm)

    def _stage_device(self, lm) -> torch.device:
        """Where a windowed MaskGIT call of `lm` runs: its placement's first
        device."""
        place = self._placement(lm)
        return place.device if place is not None else self.device

    def shard(self, mesh=None, tp: int = 1, sp: int = 1, devices=None) -> "Interface":
        """Place the LMs over several devices for inference (the JAX
        package's three axes):
          * "tp": tensor parallel; each LM's layers split Megatron-style
            over the mesh's tp axis (`TensorParallelStack`: heads, GEGLU
            units, the T5 bias by heads; an int8 LM keeps fc and w_2 whole,
            see `modules/transformer.py`);
          * "dp": data parallel; the LMs replicated over the mesh's dp axis,
            a batch's rows split over the dp groups where they divide;
          * "sp": sequence parallel (`sp > 1`, exclusive with tp and a
            mesh); the coarse LM's layers run as a `RingStack` over an
            ("sp",) mesh of `sp` devices and `coarse_vamp` defaults to the
            chunk-free path (`_shard_sequence`).
        `mesh` is a ("dp", "tp") `parallel.Mesh`; without one,
        `make_mesh(tp=tp, devices=devices)` (every CUDA device by default; a
        list may repeat a device, as `["cuda:0"] * 4` or `["cpu"] * 8`).
        The codec and the codebook tables stay on the Interface's device,
        which must be the mesh's first device. Leaves an earlier
        `shard(sp=)` or `shard_pipeline()`.

        Under sp, as in the JAX package: sketch2sound controls are refused,
        `sampler_impl` stays "auto" (the port's one sampler, K10, runs on the
        gathered logits) and `VampEngine(data_parallel=True)` raises (an sp
        interface has no dp axis)."""
        from .parallel import make_mesh

        if sp > 1:
            assert tp == 1 and mesh is None, "sp is exclusive with tp/dp"
            return self._shard_sequence(sp, devices)
        if mesh is None:
            mesh = make_mesh(tp=tp, devices=devices)
        if mesh.device_list()[0] != self.device:
            raise ValueError(f"the mesh starts on {mesh.device_list()[0]}, the Interface "
                             f"lives on {self.device}: the logits meet on the mesh's first "
                             "device, which must be the Interface's")
        self.placement = InterfacePlacement(lms={
            name: Placement(lm, mesh)
            for name, lm in (("coarse", self.coarse), ("c2f", self.c2f)) if lm is not None},
            mesh=mesh)
        return self

    def _shard_sequence(self, sp: int, devices=None) -> "Interface":
        """Sequence parallel over an ("sp",) mesh of `sp` devices: the
        coarse LM's placement (a `RingStack` over its layers) runs the
        chunk-free `coarse_vamp`; the windowed calls (`chunked=True`,
        `vamp_e2e`, `vamp_microbatched`) run the LM unplaced. The c2f LM is
        not placed (its windows run on the Interface's device). A dp/tp mesh
        of an earlier `shard()` is dropped, so the data-parallel engine
        refuses this interface."""
        from .parallel.mesh import make_sp_mesh

        mesh = make_sp_mesh(n_devices=sp, devices=devices)
        if mesh.size != sp:
            raise ValueError(f"shard(sp={sp}) found {mesh.size} devices")
        if mesh.device_list()[0] != self.device:
            raise ValueError(f"the sp mesh starts on {mesh.device_list()[0]}, the Interface "
                             f"lives on {self.device}")
        self.placement = InterfacePlacement(lms={"coarse": Placement(self.coarse, mesh)}, sp=sp)
        return self

    def shard_pipeline(self, n_coarse_devices: Optional[int] = None, tp: int = 1,
                       devices=None) -> "Interface":
        """Pipeline placement: coarse on the first `n_coarse_devices`
        devices, c2f and the decode codec on the rest, each slice a
        ("dp", "tp") mesh (batch rows split over its dp groups where they
        divide). The default split is about 3:1, as in the JAX package.
        Each stage runs on its slice's first device; `vamp_microbatched`
        then queues group g's c2f on slice B behind group g+1's coarse on
        slice A, which overlap where the slices are distinct devices (on one
        card the stages run in turn). `vamp_e2e` refuses a pipeline
        interface; `quantize()` and a swapped model unwind it."""
        if self.c2f is None:
            raise ValueError("pipeline placement needs both stages")
        from .parallel import make_mesh

        devices = [torch.device(d) for d in (
            devices if devices is not None else make_mesh().device_list())]
        n = len(devices)
        assert n >= 2, f"pipeline placement needs >=2 devices, got {n}"
        if n_coarse_devices is None:
            n_coarse_devices = max(tp, min(n - tp, round(n * PIPELINE_COARSE_SHARE) // tp * tp))
        assert 0 < n_coarse_devices < n, (
            f"coarse slice {n_coarse_devices} must leave c2f >=1 of {n} devices")
        mesh_a = make_mesh(devices=devices[:n_coarse_devices], tp=tp)
        mesh_b = make_mesh(devices=devices[n_coarse_devices:], tp=tp)
        c2f = Placement(self.c2f, mesh_b)
        self.placement = InterfacePlacement(
            lms={"coarse": Placement(self.coarse, mesh_a), "c2f": c2f},
            mesh=mesh_a,  # the engine's dp rounding keys off the coarse slice
            codec_decode=self.codec if c2f.device == self.device else
            copy.deepcopy(self.codec).to(c2f.device))
        return self

    # ---------- time/token conversion ----------

    def s2t(self, seconds: float) -> int:
        """seconds -> tokens."""
        sr, hop = self.codec_config.sample_rate, self.codec_config.hop_length
        return math.ceil(seconds * sr / hop)

    def t2s(self, tokens):
        """tokens -> seconds."""
        sr, hop = self.codec_config.sample_rate, self.codec_config.hop_length
        return tokens * hop / sr

    def s2t2s(self, seconds):
        return self.t2s(self.s2t(seconds))

    def set_chunk_size(self, chunk_size_s: float):
        """The coarse LM's chunk length in seconds (the serving apps set it
        before each vamp)."""
        self.coarse.chunk_size_s = chunk_size_s

    def to(self, device) -> "Interface":
        """Move the codec, both LMs, the codebook tables and the beat
        tracker to `device` (the JAX package only records the device, since
        JAX places arrays itself). A placement (`shard`, `shard_pipeline`)
        is dropped: the LMs run whole on `device`. Returns the Interface."""
        device = resolve_device(device)
        self.placement = InterfacePlacement()
        self.codec.to(device)
        for lm in (self.coarse, self.c2f):
            if lm is not None:
                lm.to(device)
        self.codebooks = self.codebooks.to(device)
        if self.beat_tracker is not None:
            self.beat_tracker.to(device)
        self.device = next(self.codec.parameters()).device  # "cuda" -> "cuda:0"
        return self

    # ---------- codec ----------

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
    def encode(self, signal: AudioSignal) -> torch.Tensor:
        """AudioSignal -> codes (b, n_codebooks, T) int64 on the device."""
        signal = self._preprocess(signal)
        audio = torch.from_numpy(np.ascontiguousarray(signal.samples.transpose(0, 2, 1)))
        return self.codec.encode(audio.to(self.device))

    @torch.inference_mode()
    def decode(self, z) -> AudioSignal:
        """codes -> AudioSignal. MASK tokens decode as code 0, and a frame
        whose every codebook is MASK is silenced, as in the JAX package."""
        z = self._tensor(z)
        mask_token = self.coarse.mask_token
        codec = self.placement.codec_decode
        codec = self.codec if codec is None else codec
        z = z.to(next(codec.parameters()).device)
        audio = codec.decode_codes(torch.where(z == mask_token, 0, z))
        all_masked = (z == mask_token).all(dim=1)  # (b, T)
        b, t = all_masked.shape
        hop = self.codec_config.hop_length
        audio = audio[:, : t * hop, :].reshape(b, t, hop) * (~all_masked)[:, :, None]
        return AudioSignal(audio.reshape(b, t * hop, 1).cpu().numpy().transpose(0, 2, 1),
                           self.codec_config.sample_rate)

    # ---------- masks ----------

    def _tensor(self, x) -> torch.Tensor:
        """Codes or a mask (a tensor or an array) as an int64 tensor on the
        device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device, torch.int64)

    def _generator(self, seed, device=None) -> torch.Generator:
        """A generator on `device` (the Interface's by default), seeded by
        `seed` (None: a random seed)."""
        if seed is not None and np.ndim(seed) > 0:
            raise NotImplementedError(
                "per-row seeds reach coarse_vamp and coarse_to_fine only; masks and "
                "vamp_e2e take one seed")
        gen = torch.Generator(device=self.device if device is None else device)
        gen.manual_seed(int(seed) if seed is not None else int(np.random.randint(0, 2**31 - 1)))
        return gen

    def _rng(self, seed, device=None):
        """A generation stage's randomness as (generator, row_keys), one of
        them None: per-row keys (b, 2) for a seed array, else a generator
        (`_generator`), on `device` (the Interface's by default)."""
        device = self.device if device is None else device
        if seed is not None and np.ndim(seed) > 0:
            return None, _keys_from_seeds(seed, device)
        return self._generator(seed, device), None

    def _mask_pipeline(self, z, gen, rand_mask_intensity, n_prefix, n_suffix,
                       periodic_prompt, periodic_prompt_width, _dropout,
                       upper_codebook_mask, ncc, onset=None):
        """The mask operators of the JAX `build_mask`, drawing from `gen` in
        its order: random, inpaint, rolled periodic, the onset mask where one
        is given, dropout, then the codebook masks."""
        m = pmask.linear_random(gen, z, rand_mask_intensity)
        m = pmask.mask_and(m, pmask.inpaint(z, n_prefix, n_suffix))
        m = pmask.mask_and(m, pmask.periodic_mask(
            z, int(periodic_prompt), int(periodic_prompt_width), random_roll=True,
            generator=gen))
        if onset is not None:
            m = pmask.mask_and(m, onset)
        m = pmask.dropout(gen, m, float(_dropout))
        m = pmask.codebook_unmask(m, int(ncc))
        return pmask.codebook_mask(m, int(upper_codebook_mask))

    @torch.inference_mode()
    def build_mask(
        self,
        z,
        sig: Optional[AudioSignal] = None,
        rand_mask_intensity: float = 1.0,
        prefix_s: float = 0.0,
        suffix_s: float = 0.0,
        periodic_prompt: int = 7,
        periodic_prompt_width: int = 1,
        onset_mask_width: int = 0,
        _dropout: float = 0.0,
        upper_codebook_mask: int = 3,
        ncc: int = 0,
        seed: Optional[int] = None,
    ) -> torch.Tensor:
        """The JAX `build_mask`: (b, n_codebooks, T) int64, 1 = regenerate.
        With `onset_mask_width > 0` the onsets of `sig` (`beats.detect_onsets`,
        on the host) are kept, `onset_mask_width` frames either side."""
        z = self._tensor(z)
        onset = None
        if onset_mask_width > 0:
            if sig is None:
                raise ValueError("the onset mask needs the signal (sig=)")
            from .beats import detect_onsets

            onsets = detect_onsets(sig, hop_length=self.codec_config.hop_length)
            onset = pmask.onset_mask(onsets, z, width=int(onset_mask_width))
        return self._mask_pipeline(
            z, self._generator(seed), rand_mask_intensity, self.s2t(prefix_s),
            self.s2t(suffix_s), periodic_prompt, periodic_prompt_width, _dropout,
            upper_codebook_mask, ncc, onset)

    def make_beat_mask(
        self,
        signal: AudioSignal,
        before_beat_s: float = 0.0,
        after_beat_s: float = 0.02,
        mask_downbeats: bool = True,
        mask_upbeats: bool = True,
        downbeat_downsample_factor: Optional[int] = None,
        beat_downsample_factor: Optional[int] = None,
        dropout: float = 0.0,
        invert: bool = True,
    ) -> torch.Tensor:
        """The JAX `make_beat_mask`: (1, n_codebooks, T) int64 on the device,
        0 from `before_beat_s` before each beat to `after_beat_s` after it
        (with `invert`), 1 elsewhere. `dropout` drops a share of the kept
        steps at random (numpy's unseeded generator, as in JAX)."""
        if self.beat_tracker is None:
            raise ValueError("no beat tracker loaded (wavebeat_ckpt)")
        beats, downbeats = self.beat_tracker.extract_beats(signal)
        beats_z = [int(self.s2t(b)) for b in beats]
        downbeats_z = [int(self.s2t(b)) for b in downbeats]
        beats_z = [b for b in beats_z if b not in set(downbeats_z)]

        seq_len = self.s2t(signal.duration)
        mask = np.zeros(seq_len, dtype=np.int64)
        mask_b4 = self.s2t(before_beat_s)
        mask_after = self.s2t(after_beat_s)
        beats_z = beats_z[::max(1, beat_downsample_factor or 1)]
        downbeats_z = downbeats_z[::max(1, downbeat_downsample_factor or 1)]

        rng = np.random.default_rng()
        idx_lists = ([beats_z] if mask_upbeats else []) + ([downbeats_z] if mask_downbeats else [])
        for idxs in idx_lists:
            for beat_idx in idxs:
                lo, hi = max(int(beat_idx - mask_b4), 0), min(int(beat_idx + mask_after), seq_len)
                mask[lo:hi] = (rng.random(hi - lo) >= dropout).astype(np.int64)
        mask = np.clip(mask, 0, 1)
        if invert:
            mask = 1 - mask
        n_cb = (self.c2f if self.c2f is not None else self.coarse).config.n_codebooks
        return self._tensor(np.tile(mask[None, None, :], (1, n_cb, 1)))

    def snap_to_beats(self, signal: AudioSignal) -> AudioSignal:
        """`signal` trimmed to start at its first beat and end at its last."""
        if self.beat_tracker is None:
            raise ValueError("no beat tracker loaded (wavebeat_ckpt)")
        beats, _ = self.beat_tracker.extract_beats(signal)
        samples_begin = int(beats[0] * signal.sample_rate)
        samples_end = int(beats[-1] * signal.sample_rate)
        return signal.clone().trim(samples_begin, signal.length - samples_end)

    # ---------- generation ----------

    def _chunk_fns(self, n_cb: int, b: int, t: int, chunk_len: int, mask_token: int,
                   pin_edges: bool):
        """Chunk-as-batch windowing: ((pre, post), n_chunks).

        pre:  (cz (b, C, t), m (b, C, t)) -> (masked chunks, mask chunks),
              both (n_chunks * b, C, chunk_len), padded to n_chunks * chunk_len
              (codes with 0, the mask with 1); with `pin_edges` a chunk's first
              and last steps are kept wherever any step of that chunk is kept
              (seam continuity).
        post: chunks (n_chunks * b, C, chunk_len) -> (b, C, t).
        Rows are chunk-major: row = chunk * b + batch row."""
        n_chunks = math.ceil(t / chunk_len)
        pad = n_chunks * chunk_len - t
        lo_idx = [i * chunk_len for i in range(n_chunks)]
        hi_idx = [min(t, (i + 1) * chunk_len) - 1 for i in range(n_chunks)]

        def to_chunks(x):
            x = x.reshape(b, n_cb, n_chunks, chunk_len).permute(2, 0, 1, 3)
            return x.reshape(n_chunks * b, n_cb, chunk_len)

        def pre(cz, m):
            if pin_edges:
                chunked = F.pad(m, (0, pad), value=1).reshape(b, n_cb, n_chunks, chunk_len)
                has_zero = (chunked == 0).any(dim=3).any(dim=1).any(dim=0)  # (n_chunks,)
                pin = torch.where(has_zero, 0, 1).to(m.dtype)
                m = m.clone()
                lo = torch.tensor(lo_idx, device=m.device)
                hi = torch.tensor(hi_idx, device=m.device)
                m[:, :, lo] = torch.minimum(m[:, :, lo], pin)
                m[:, :, hi] = torch.minimum(m[:, :, hi], pin)
            cz_c = to_chunks(F.pad(cz, (0, pad)))
            m_c = to_chunks(F.pad(m, (0, pad), value=1))
            return torch.where(m_c.bool(), mask_token, cz_c), m_c

        def post(x):
            x = x.reshape(n_chunks, b, n_cb, chunk_len).permute(1, 2, 0, 3)
            return x.reshape(b, n_cb, n_chunks * chunk_len)[:, :, :t]

        return (pre, post), n_chunks

    def _run_generate(
        self,
        lm: VampNetLM,
        start_tokens: torch.Tensor,
        mask: torch.Tensor,
        generator: Optional[torch.Generator],
        row_keys: Optional[torch.Tensor] = None,
        _sampling_steps: int = 12,
        temperature=1.0,
        mask_temperature=10.5,
        typical_filtering: bool = True,
        typical_mass: float = 0.15,
        typical_min_tokens: int = 64,
        top_k: Optional[int] = None,
        top_p=None,
        sample_cutoff=1.0,
        cfg_guidance: Optional[float] = None,
        sampler_impl: str = "auto",
        row_key_offset: Optional[int] = None,
        debug_callback: Optional[Callable] = None,
        whole_sequence: bool = False,
    ) -> torch.Tensor:
        """MaskGIT over chunk rows with `lm`, the T5 bias built once for the
        chunk length. Randomness comes from `generator`, or from per-request
        keys `row_keys` (b, 2) where given. Per-request (b,) parameters and
        keys are tiled over the chunk rows, as in the JAX package: keys are
        folded with the global chunk index (`_expand_row_keys`, chunk 0 at
        `row_key_offset`) where a request has several chunk rows or an
        offset is given, and used as they are otherwise. `top_k` goes to the
        sampler kernel; `cfg_guidance` appends one unconditional row per row
        (`generate`). `debug_callback` goes to `generate`
        (`sampling/debug.py`).

        A placed LM (`shard`, `shard_pipeline`) runs its forward through the
        placement `_placement` gives the call (`whole_sequence`: the
        chunk-free sp path) and the loop on the placement's first device,
        `generator` and `row_keys` there too; the codes come back to the
        device the start tokens came from."""
        if sampler_impl != "auto":
            raise NotImplementedError(
                f"sampler_impl={sampler_impl!r}: the port has one sampler, the fused "
                "kernel (sampler_impl='auto')")
        place = self._placement(lm, whole_sequence)
        dev = place.device if place is not None else self.device
        home = start_tokens.device
        start_tokens, mask = start_tokens.to(dev), mask.to(dev)
        if row_keys is not None:
            row_keys = row_keys.to(dev)
        b_total, n_cb, chunk_len = start_tokens.shape

        def expand(v):
            if v is None or np.ndim(v) == 0:
                return v
            v = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                dtype=torch.float32, device=dev)
            if v.shape[0] != b_total:
                if b_total % v.shape[0]:
                    raise ValueError(f"per-row param of size {v.shape[0]} does not divide "
                                     f"batch {b_total}")
                v = v.repeat(b_total // v.shape[0])
            return v

        if row_keys is not None and (row_keys.shape[0] != b_total
                                     or row_key_offset is not None):
            if b_total % row_keys.shape[0]:
                raise ValueError(f"per-row keys of size {row_keys.shape[0]} do not "
                                 f"divide batch {b_total}")
            row_keys = _expand_row_keys(row_keys, b_total // row_keys.shape[0],
                                        int(row_key_offset or 0))
        # the ring stack builds its own bias blocks: no (t, t) bias there
        bias = None if whole_sequence else position_bias_from_params(lm, chunk_len)
        cbs = self.codebooks[:n_cb]
        if place is not None:
            forward = lambda zm: place.forward_codes(zm, cbs, bias)  # noqa: E731
        else:
            forward = lambda zm: lm.forward_codes(zm, cbs, position_bias=bias)  # noqa: E731
        return generate(
            forward, start_tokens, mask, lm.mask_token, generator,
            n_conditioning_codebooks=lm.config.n_conditioning_codebooks,
            sampling_steps=int(_sampling_steps), temperature=expand(temperature),
            mask_temperature=expand(mask_temperature),
            typical_filtering=bool(typical_filtering), typical_mass=float(typical_mass),
            typical_min_tokens=int(typical_min_tokens), top_k=top_k, top_p=expand(top_p),
            sample_cutoff=expand(sample_cutoff), row_keys=row_keys,
            cfg_guidance=None if cfg_guidance is None else float(cfg_guidance),
            debug_callback=debug_callback,
        ).to(home)

    @torch.inference_mode()
    def coarse_vamp(self, z, mask, return_mask: bool = False,
                    gen_fn: Optional[Callable] = None, seed=None,
                    chunked: Optional[bool] = None, **kwargs):
        """Vamp the coarse codebooks in chunks of `coarse.chunk_size_s`, the
        chunks as batch rows, with chunk-edge pinning. Returns the codes with
        the fine codebooks re-appended from z (and, with `return_mask`, the
        masked coarse codes). `seed` is an int (one generator) or an array of
        b seeds (per-row keys). `gen_fn(start_tokens=, mask=, generator=,
        **kwargs)` replaces the MaskGIT call; with a seed array it gets
        `generator=None` and `row_keys=`.

        After `shard(sp=N)` the default is the chunk-free path
        (`chunked=False`, `_coarse_vamp_unchunked`): one ring-attention
        generate over the whole sequence, no windows and no seam pinning.
        `chunked=True` forces the windows there (the LM unplaced)."""
        if chunked is None:
            chunked = self.placement.sp == 1
        if not chunked:
            return self._coarse_vamp_unchunked(z, mask, return_mask=return_mask, seed=seed,
                                               **kwargs)
        z, mask = self._tensor(z), self._tensor(mask)
        lm = self.coarse
        n_coarse = lm.config.n_codebooks
        b, _, t = z.shape
        (pre, post), _ = self._chunk_fns(n_coarse, b, t, self.s2t(lm.chunk_size_s),
                                         lm.mask_token, pin_edges=True)
        cz_masked, m_chunks = pre(z[:, :n_coarse], mask[:, :n_coarse])
        generator, row_keys = self._rng(seed, self._stage_device(lm))
        if gen_fn is not None:
            if row_keys is not None:
                kwargs["row_keys"] = row_keys
            chunks = gen_fn(start_tokens=cz_masked, mask=m_chunks, generator=generator,
                            **kwargs)
        else:
            chunks = self._run_generate(lm, cz_masked, m_chunks, generator,
                                        row_keys=row_keys, **kwargs)
        c_vamp = post(chunks)
        if z.shape[1] > n_coarse:
            c_vamp = torch.cat([c_vamp, z[:, n_coarse:]], dim=1)
        if return_mask:
            return c_vamp, post(cz_masked)
        return c_vamp

    def sp_pad_len(self, t: int) -> int:
        """The length the chunk-free (sp) path runs a t-token sequence at:
        the time shards must be equal, so t is padded up to a multiple of sp
        (of 128 sp once a shard reaches 128 tokens). The padded tail is
        fully masked and cropped after generation. The engine buckets sp
        requests on this grid, so that batched and solo requests run the
        same sequence length (a longer one changes the tokens: padded
        positions attend and count in the MaskGIT schedule)."""
        n_sp = self.placement.sp
        assert n_sp > 1, "sp_pad_len requires shard(sp=N)"
        mult = n_sp * (128 if t >= n_sp * 128 else 1)
        return ((t + mult - 1) // mult) * mult

    @torch.inference_mode()
    def _coarse_vamp_unchunked(self, z, mask, return_mask: bool = False, seed=None,
                               **kwargs):
        """The chunk-free coarse vamp (sp): the whole sequence, padded to
        `sp_pad_len` with masked tokens, as one generate whose forwards run
        the ring-attention `RingStack` over the sp mesh (the (t, t) bias is
        never built); the logits meet on the mesh's first device, where K10
        samples them as on the unsharded path. Needs `shard(sp=N)`."""
        assert self.placement.sp > 1, (
            "chunk-free coarse_vamp requires interface.shard(sp=N) first")
        z, mask = self._tensor(z), self._tensor(mask)
        lm = self.coarse
        n_coarse = lm.config.n_codebooks
        b, _, t = z.shape
        pad = self.sp_pad_len(t) - t
        zp = F.pad(z[:, :n_coarse], (0, pad))
        mp = F.pad(mask[:, :n_coarse], (0, pad), value=1)
        z_masked = torch.where(mp.bool(), lm.mask_token, zp)
        generator, row_keys = self._rng(seed)  # the sp mesh starts on the Interface's device
        c_vamp = self._run_generate(lm, z_masked, mp, generator, row_keys=row_keys,
                                    whole_sequence=True, **kwargs)[:, :, :t]
        if z.shape[1] > n_coarse:
            c_vamp = torch.cat([c_vamp, z[:, n_coarse:]], dim=1)
        if return_mask:
            return c_vamp, torch.where(mask[:, :n_coarse].bool(), lm.mask_token,
                                       z[:, :n_coarse])
        return c_vamp

    @torch.inference_mode()
    def coarse_to_fine(self, z, mask=None, return_mask: bool = False, seed=None, **kwargs):
        """Fill the fine codebooks in chunks of `c2f.chunk_size_s`, batched;
        the conditioning codebooks are kept. 2 steps with the typical filter
        unless given. `seed` is an int or an array of b seeds, as in
        `coarse_vamp`."""
        if self.c2f is None:
            raise ValueError("no coarse-to-fine model loaded")
        z = self._tensor(z)
        lm = self.c2f
        b, n_cb_in, length = z.shape
        n_cb = lm.config.n_codebooks
        if n_cb > n_cb_in:
            z = torch.cat([z, torch.zeros((b, n_cb - n_cb_in, length), dtype=z.dtype,
                                          device=z.device)], dim=1)
        mask = torch.ones_like(z) if mask is None else self._tensor(mask)
        mask = pmask.codebook_unmask(mask, lm.config.n_conditioning_codebooks)
        (pre, post), _ = self._chunk_fns(n_cb, b, length, self.s2t(lm.chunk_size_s),
                                         lm.mask_token, pin_edges=False)
        z_masked, m_chunks = pre(z, mask)
        kwargs.setdefault("_sampling_steps", 2)
        kwargs.setdefault("typical_filtering", True)
        generator, row_keys = self._rng(seed, self._stage_device(lm))
        fine_z = post(self._run_generate(lm, z_masked, m_chunks, generator, row_keys=row_keys,
                                         **kwargs))
        if return_mask:
            return fine_z, torch.where(mask.bool(), lm.mask_token, fine_z)
        return fine_z

    @torch.inference_mode()
    def vamp(
        self,
        codes,
        mask,
        batch_size: int = 1,
        feedback_steps: int = 1,
        time_stretch_factor: int = 1,
        return_mask: bool = False,
        seed: Optional[int] = None,
        **kwargs,
    ):
        """The two-stage vamp of the JAX package: batch expansion, time
        stretch, `feedback_steps` coarse vamps, then coarse-to-fine. Each stage
        draws from a generator seeded by `np.random.default_rng(seed)` (an
        int or, as in the JAX package, an array of seeds as its entropy).
        Returns the codes (b, n_codebooks, T) and, with `return_mask`, the
        masked codes as a numpy array."""
        z, mask = self._tensor(codes), self._tensor(mask)
        z = z.expand((batch_size,) + z.shape[1:])
        mask = mask.expand((batch_size,) + mask.shape[1:])
        if time_stretch_factor > 1:
            z = torch.repeat_interleave(z, time_stretch_factor, dim=-1)
            mask = torch.repeat_interleave(mask, time_stretch_factor, dim=-1)
            added = torch.ones_like(mask)
            added[:, :, ::time_stretch_factor] = 0
            mask = (mask.bool() | added.bool()).to(torch.int64)
        z, mask = z.contiguous(), mask.contiguous()

        rng = np.random.default_rng(seed)
        n_coarse = self.coarse.config.n_codebooks
        zv, mask_z = z, mask
        for i in range(feedback_steps):
            zv, mask_z = self.coarse_vamp(zv, mask=mask, return_mask=True,
                                          seed=int(rng.integers(0, 2**31 - 1)), **kwargs)
            mask_z = torch.roll(mask_z, (i + 1) % feedback_steps, dims=-1)
        if zv.shape[1] < z.shape[1]:
            zv = torch.cat([zv, z[:, n_coarse:]], dim=1)

        if self.c2f is not None:
            c2f_kwargs = {k: v for k, v in kwargs.items() if k in _C2F_KWARGS}
            zv, fine_zv_mask = self.coarse_to_fine(
                zv, mask=mask, typical_filtering=True, _sampling_steps=2, return_mask=True,
                seed=int(rng.integers(0, 2**31 - 1)), **c2f_kwargs)
            mask_z = torch.cat([mask_z[:, :n_coarse], fine_zv_mask[:, n_coarse:]], dim=1)

        if return_mask:
            return zv, mask_z.cpu().numpy()
        return zv

    def vamp_microbatched(self, codes, mask, group_chunks: int = 2, seed=None, **kwargs):
        """The two-stage vamp streamed in groups of `group_chunks` coarse
        chunks: each group runs coarse_vamp, then coarse_to_fine, and the
        next group's stages queue behind them on the card's one stream (no
        synchronize between groups). The JAX package overlaps the stages of
        consecutive groups on disjoint slices of a pipeline mesh; on one
        card they run in turn, as they do on one JAX mesh.

        Each request draws from its own seed: a seed array (b,) as given,
        else b seeds from `np.random.default_rng(seed)`; the fine stage
        takes the seeds + 0x9E3779B9 (wrapping uint32). Chunk keys fold the
        global chunk index (`row_key_offset`), so the coarse codebooks do
        not depend on `group_chunks`. The c2f stage windows each group from
        its own start, so the whole output is the same for every grouping
        only where a group's length is a multiple of the c2f chunk.
        `c2f_steps` (default 2) sets the fine stage's steps."""
        z, mask = self._tensor(codes), self._tensor(mask)
        b, _, t = z.shape
        chunk_len = self.s2t(self.coarse.chunk_size_s)
        glen = group_chunks * chunk_len
        f_len = self.s2t(self.c2f.chunk_size_s) if self.c2f is not None else 0

        if seed is not None and np.ndim(seed) > 0:
            seeds_coarse = np.asarray(seed, dtype=np.uint32)
        else:
            rng = np.random.default_rng(seed)
            seeds_coarse = rng.integers(0, 2**31 - 1, size=b).astype(np.uint32)
        seeds_c2f = (seeds_coarse + np.uint32(0x9E3779B9)).astype(np.uint32)

        c2f_steps = kwargs.pop("c2f_steps", 2)
        c2f_kwargs = {k: v for k, v in kwargs.items() if k in _C2F_KWARGS}
        outs = []
        f_off = 0
        for g0 in range(0, t, glen):
            g1 = min(t, g0 + glen)
            zg, mg = z[:, :, g0:g1], mask[:, :, g0:g1]
            cv = self.coarse_vamp(zg, mg, seed=seeds_coarse, row_key_offset=g0 // chunk_len,
                                  chunked=True, **kwargs)
            if self.c2f is not None:
                cv = self.coarse_to_fine(
                    cv, mask=mg, seed=seeds_c2f, row_key_offset=f_off,
                    typical_filtering=kwargs.get("typical_filtering", True),
                    _sampling_steps=c2f_steps, **c2f_kwargs)
                f_off += math.ceil((g1 - g0) / f_len)
            outs.append(cv)
        return torch.cat(outs, dim=-1)

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
        """One vamp request, encode to decode, as `vampnet_tpu`'s `vamp_e2e`:
        one generator for the whole request, the chunk helpers of the staged
        API at both LMs' `chunk_size_s`.

        `transfer_dtype="int16"` moves the waveform between host and device
        as 16-bit PCM both ways: the input is hard-clipped to [-1, 1] and
        quantized to 1/32767 before encode, the output likewise. Only finite
        input is supported on that path (NaN has no PCM value)."""
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype must be float32 or int16, got {transfer_dtype}")
        assert not self.placement.pipeline, (
            "vamp_e2e is one request on one device and cannot span the two pipeline "
            "slices; with shard_pipeline use the staged path (encode/build_mask/vamp/"
            "decode) or serve.VampEngine")
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
        gen = self._generator(seed)

        codes = self.codec.encode(audio)[:, :, :t_tokens]
        m = self._mask_pipeline(codes, gen, rand_mask_intensity, self.s2t(prefix_s),
                                self.s2t(suffix_s), periodic_prompt, periodic_prompt_width,
                                _dropout, upper_codebook_mask, 0)

        # ---- batch expand + coarse chunks as batch rows ----
        z = codes.expand((batch_size,) + codes.shape[1:]).contiguous()
        m = m.expand((batch_size,) + m.shape[1:]).contiguous()
        coarse, c2f = self.coarse, self.c2f
        n_coarse = coarse.config.n_codebooks
        sampling = dict(temperature=temperature, mask_temperature=mask_temperature,
                        typical_mass=typical_mass, typical_min_tokens=typical_min_tokens,
                        sample_cutoff=sample_cutoff)
        (pre, post), _ = self._chunk_fns(n_coarse, batch_size, t_tokens,
                                         self.s2t(coarse.chunk_size_s), coarse.mask_token,
                                         pin_edges=True)
        z_masked, cm_c = pre(z[:, :n_coarse], m[:, :n_coarse])
        cv = self._run_generate(coarse, z_masked, cm_c, gen, _sampling_steps=_sampling_steps,
                                typical_filtering=typical_filtering, top_p=top_p, **sampling)
        zv = post(cv)

        # ---- c2f ----
        if c2f is not None:
            n_cb = c2f.config.n_codebooks
            (pre, post), _ = self._chunk_fns(n_cb, batch_size, t_tokens,
                                             self.s2t(c2f.chunk_size_s), coarse.mask_token,
                                             pin_edges=False)
            zf_masked, mf_c = pre(torch.cat([zv, z[:, n_coarse:]], dim=1),
                                  pmask.codebook_unmask(m, c2f.config.n_conditioning_codebooks))
            fv = self._run_generate(c2f, zf_masked, mf_c, gen, _sampling_steps=c2f_steps,
                                    typical_filtering=True, **sampling)
            zv = post(fv)

        # ---- decode ----
        z0 = torch.where(zv == coarse.mask_token, 0, zv)
        wav = self.codec.decode_codes(z0)[:, : t_tokens * hop]
        if transfer_dtype == "int16":
            wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        out = wav.cpu().numpy()
        if out.dtype == np.int16:
            out = out.astype(np.float32) * (1.0 / 32767.0)
        return AudioSignal(out.transpose(0, 2, 1), self.codec_config.sample_rate)

    # ---------- utilities ----------

    def visualize_codes(self, z):
        """A matplotlib figure of the first row's codes (codebook by
        step)."""
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(10, 7))
        fig.add_subplot(2, 1, 1)
        plt.imshow(self._tensor(z)[0].cpu().numpy(), aspect="auto", origin="lower",
                   cmap="tab20", interpolation="none")
        plt.title("codes")
        plt.ylabel("codebook index")
        return fig
