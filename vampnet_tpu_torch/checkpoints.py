"""Checkpoint files for the LM and the codec (counterpart of
`vampnet_tpu/checkpoints.py`).

Two formats, as in the JAX package:
  * native `.vtpu`: `MAGIC`, then flax's msgpack of {"kind", "config" (JSON),
    "params"} (`_msgpack.py`); files move between the two packages both ways;
  * upstream torch `.pth` (audiotools layout or raw state dicts), converted
    on load (`convert.py`, `codec/convert.py`).

Loaders return `(config, tree)`: the tree is a flax-shaped nested dict of
CPU tensors in the file's dtypes (bf16 as `torch.bfloat16`), which
`convert.lm_state_dict_from_jax`/`codec_state_dict_from_jax` turn into the
port's state dicts. Savers take such a tree, of tensors or numpy arrays.
The wavebeat tracker's pair (`save_wavebeat`, `load_wavebeat`) takes and
gives the port's `DsTCN` state dict and writes the JAX package's flax
layout, its BatchNorms already folded.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping, Optional, Tuple

from . import _msgpack
from .codec import CodecConfig
from .codec.convert import codec_from_torch_checkpoint
from .convert import lm_from_torch_checkpoint, lora_from_torch_checkpoint
from .modules import LMConfig
from .modules.lora import merge_lora_state_dict
from .wavebeat import (
    DsTCNConfig,
    dstcn_from_torch_checkpoint,
    dstcn_state_dict_from_tree,
    dstcn_tree_from_state_dict,
)

MAGIC = b"VTPU1\n"


def _config_to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    if d.get("ctrl_dims") is not None:
        d["ctrl_dims"] = [list(x) for x in d["ctrl_dims"]]
    return d


def _lm_config_from_dict(d: dict) -> LMConfig:
    if d.get("ctrl_dims") is not None:
        d["ctrl_dims"] = tuple((k, int(v)) for k, v in d["ctrl_dims"])
    return LMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _sorted(tree):
    """Maps in sorted key order, as flax writes them (jax's tree flattening
    sorts dict keys), so that both packages write the same bytes."""
    if isinstance(tree, Mapping):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _save(path, kind: str, config: str, params: Mapping) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        _msgpack.pack_into(f, _sorted({"kind": kind, "config": config, "params": params}))


def save_lm(path, config: LMConfig, params: Mapping) -> None:
    _save(path, "vampnet_lm", json.dumps(_config_to_dict(config)), params)


def save_codec(path, config: CodecConfig, params: Mapping) -> None:
    _save(path, "vampnet_codec", json.dumps(dataclasses.asdict(config)), params)


def save_lora(path, lora_params: Mapping) -> None:
    _save(path, "vampnet_lora", "{}", lora_params)


def _load_native(path) -> Optional[dict]:
    """The payload of a `.vtpu` file, or None if the file is not one."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            return None
        f.seek(0, 2)
        buf = bytearray(f.tell() - len(MAGIC))
        f.seek(len(MAGIC))
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return _msgpack.unpackb(buf)


def _check_kind(payload: dict, kind: str, path) -> None:
    if payload.get("kind") != kind:
        raise ValueError(f"{path} holds a {payload.get('kind')!r} checkpoint, not {kind!r}")


def load_lm(path, lora_path=None) -> Tuple[LMConfig, dict]:
    """Load an LM checkpoint (.vtpu or upstream .pth), then overlay a
    LoRA-only checkpoint if one is given (upstream's lenient base load plus
    adapters)."""
    payload = _load_native(path)
    if payload is not None:
        _check_kind(payload, "vampnet_lm", path)
        cfg = _lm_config_from_dict(json.loads(payload["config"]))
        params = payload["params"]
    else:
        cfg, params = lm_from_torch_checkpoint(path)
    if lora_path is not None:
        params = _overlay_lora(params, lora_path)
    return cfg, params


def _overlay_lora(params: Mapping, lora_path) -> dict:
    payload = _load_native(lora_path)
    if payload is not None:
        lora_params = payload["params"]
    else:
        lora_params = lora_from_torch_checkpoint(lora_path)
    return merge_lora_state_dict(params, lora_params)


def load_codec(path) -> Tuple[CodecConfig, dict]:
    """Load a codec checkpoint (.vtpu or upstream .pth)."""
    payload = _load_native(path)
    if payload is not None:
        _check_kind(payload, "vampnet_codec", path)
        cfg = CodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in json.loads(payload["config"]).items()})
        return cfg, payload["params"]
    return codec_from_torch_checkpoint(path)


def save_wavebeat(path, config, state_dict: Mapping) -> None:
    """A wavebeat (dsTCN) `DsTCN` state dict, BatchNorms folded, as a `.vtpu`
    file in the JAX package's flax layout."""
    _save(path, "vampnet_wavebeat", json.dumps(dataclasses.asdict(config)),
          dstcn_tree_from_state_dict(state_dict))


def load_wavebeat(path):
    """A wavebeat checkpoint (`.vtpu` of either package, or a Lightning
    `.pth`/`.ckpt`) -> (`DsTCNConfig`, `DsTCN` state dict)."""
    payload = _load_native(path)
    if payload is not None:
        _check_kind(payload, "vampnet_wavebeat", path)
        cfg = DsTCNConfig.from_dict(json.loads(payload["config"]))
        return cfg, dstcn_state_dict_from_tree(payload["params"])
    return dstcn_from_torch_checkpoint(path)
