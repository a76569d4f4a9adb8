"""Upstream codec checkpoints to the port (counterpart of
`vampnet_tpu/codec/convert.py`).

Reads the DAC-family torch layout that `lac` checkpoints use (nested
Sequential blocks of weight-norm convs and snake activations, an RVQ with
per-stage in/out projections) into a flax-shaped tree of CPU tensors:

  encoder.block.0                  -> encoder/conv_in
  encoder.block.{i+1}.block.{0..2} -> encoder/block_{i}/res_{1..3}
  encoder.block.{i+1}.block.3      -> encoder/block_{i}/snake
  encoder.block.{i+1}.block.4      -> encoder/block_{i}/conv
  decoder.model.*                  -> decoder/* (mirrored)
  quantizer.quantizers.{i}.*       -> quantizer/quantizers_{i}/*

Weight-norm (g, v) pairs are kept (the codec layers keep that
parametrization); snake alphas reshape (1, C, 1) -> (C,).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..convert import _load_torch_state_dict
from ..util import unflatten_tree
from .model import CodecConfig


def infer_codec_config(sd: Dict[str, np.ndarray], metadata: dict) -> CodecConfig:
    """A `CodecConfig` from the shapes (strides from the conv kernel sizes,
    k = 2 * stride) and the metadata's sample rate."""
    kwargs = dict(metadata.get("kwargs", {})) if metadata else {}
    n_cb = 0
    while f"quantizer.quantizers.{n_cb}.codebook.weight" in sd:
        n_cb += 1
    codebook_size, codebook_dim = sd["quantizer.quantizers.0.codebook.weight"].shape
    rates = []
    i = 1
    while f"encoder.block.{i}.block.4.weight_v" in sd:
        rates.append(sd[f"encoder.block.{i}.block.4.weight_v"].shape[2] // 2)
        i += 1
    dec_rates = []
    i = 1
    while f"decoder.model.{i}.block.1.weight_v" in sd:
        dec_rates.append(sd[f"decoder.model.{i}.block.1.weight_v"].shape[2] // 2)
        i += 1
    return CodecConfig(
        sample_rate=int(kwargs.get("sample_rate", 44100)),
        encoder_dim=sd["encoder.block.0.weight_v"].shape[0],
        encoder_rates=tuple(rates),
        decoder_dim=sd["decoder.model.0.weight_v"].shape[0],
        decoder_rates=tuple(dec_rates),
        n_codebooks=n_cb,
        codebook_size=codebook_size,
        codebook_dim=codebook_dim,
    )


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _put_wn_conv(flat, path, sd, base):
    flat[path + ("v",)] = _t(sd[f"{base}.weight_v"])
    flat[path + ("g",)] = _t(sd[f"{base}.weight_g"].reshape(-1))
    if f"{base}.bias" in sd:
        flat[path + ("bias",)] = _t(sd[f"{base}.bias"])


def _put_snake(flat, path, sd, base):
    flat[path + ("alpha",)] = _t(sd[f"{base}.alpha"].reshape(-1))


def _put_res_unit(flat, path, sd, base):
    _put_snake(flat, path + ("snake_1",), sd, f"{base}.block.0")
    _put_wn_conv(flat, path + ("conv_1",), sd, f"{base}.block.1")
    _put_snake(flat, path + ("snake_2",), sd, f"{base}.block.2")
    _put_wn_conv(flat, path + ("conv_2",), sd, f"{base}.block.3")


def codec_params_from_state_dict(sd: Dict[str, np.ndarray], cfg: CodecConfig) -> Dict:
    flat: Dict[Tuple[str, ...], torch.Tensor] = {}

    _put_wn_conv(flat, ("encoder", "conv_in"), sd, "encoder.block.0")
    n_enc = len(cfg.encoder_rates)
    for i in range(n_enc):
        base, p = f"encoder.block.{i + 1}", ("encoder", f"block_{i}")
        for j in range(3):
            _put_res_unit(flat, p + (f"res_{j + 1}",), sd, f"{base}.block.{j}")
        _put_snake(flat, p + ("snake",), sd, f"{base}.block.3")
        _put_wn_conv(flat, p + ("conv",), sd, f"{base}.block.4")
    _put_snake(flat, ("encoder", "snake_out"), sd, f"encoder.block.{n_enc + 1}")
    _put_wn_conv(flat, ("encoder", "conv_out"), sd, f"encoder.block.{n_enc + 2}")

    for i in range(cfg.n_codebooks):
        base, p = f"quantizer.quantizers.{i}", ("quantizer", f"quantizers_{i}")
        _put_wn_conv(flat, p + ("in_proj",), sd, f"{base}.in_proj")
        _put_wn_conv(flat, p + ("out_proj",), sd, f"{base}.out_proj")
        flat[p + ("codebook",)] = _t(sd[f"{base}.codebook.weight"])

    _put_wn_conv(flat, ("decoder", "conv_in"), sd, "decoder.model.0")
    n_dec = len(cfg.decoder_rates)
    for i in range(n_dec):
        base, p = f"decoder.model.{i + 1}", ("decoder", f"block_{i}")
        _put_snake(flat, p + ("snake",), sd, f"{base}.block.0")
        # a transposed conv's v is (in, out, k) in torch and in the codec
        _put_wn_conv(flat, p + ("conv_t",), sd, f"{base}.block.1")
        for j in range(3):
            _put_res_unit(flat, p + (f"res_{j + 1}",), sd, f"{base}.block.{j + 2}")
    _put_snake(flat, ("decoder", "snake_out"), sd, f"decoder.model.{n_dec + 1}")
    _put_wn_conv(flat, ("decoder", "conv_out"), sd, f"decoder.model.{n_dec + 2}")
    return unflatten_tree(flat)


def codec_from_torch_checkpoint(path) -> Tuple[CodecConfig, Dict]:
    sd, metadata = _load_torch_state_dict(path)
    cfg = infer_codec_config(sd, metadata)
    return cfg, codec_params_from_state_dict(sd, cfg)
