"""Weight bridges (counterpart of `vampnet_tpu/convert.py`).

1. Flax-shaped param trees (nested dicts of tensors or numpy arrays, as
   `checkpoints.load_lm`/`load_codec` return them and as the JAX package
   holds them) to the port's state dicts, and, for the LM, back. The port
   names its parameters after the flax tree (`layers_0`, `w_qs`,
   `quantizers_3`, ...), so a flax path "a/b/kernel" becomes the key
   "a.b.weight" and nothing is reordered:
   * Dense kernels are stored (in, out) by flax and (out, in) by
     `torch.nn.Linear`: they are transposed. The classifier keeps its
     codebook-major column order. LoRA adapters keep the flax orientation
     under their flax names, `lora_a` (in, r) and `lora_b` (r, out).
   * An int8-quantized LM (`quantize_lm_params` in the JAX package) carries
     `kernel_q` (in, out) int8 and `kernel_scale` (out,) fp32 at each
     projection; they become `w_q` (out, in) int8 and `w_scale` fp32.
   * The codec's weight-norm pairs carry over as they are: flax already
     stores v as (out, in, k) for a conv and (in, out, k) for a transposed
     conv, torch's layouts (the JAX layers transpose to WIO at call time).
   Float leaves become fp32 tensors (bf16 ones exactly, without numpy).

2. Upstream VampNet's torch checkpoints (audiotools `{"state_dict",
   "metadata": {"kwargs"}}` files or raw state dicts, with `module.` or
   `_orig_mod.` prefixes; loralib adapter-only files) to flax-shaped trees
   of CPU tensors, as the JAX package converts them:
     torch Linear weight (out, in)            -> kernel (in, out) = W.T
     torch Conv1d k=1 weight (out, in, 1)     -> kernel = W[:, :, 0].T
     weight-norm (g, v) of the classifier     -> W = g v / ||v||, its output
                                                 channels permuted from
                                                 vocab-major to codebook-major
     loralib lora_A (r, in) / lora_B (out, r) -> lora_a = A.T / lora_b = B.T
     embedding.special.MASK                   -> embedding/special_MASK
     ctrl_encoder.ctrl_encoders.{name}.weight -> ctrl_encoder/ctrl_{name}/kernel = W.T
   The arithmetic is numpy fp32, as in the JAX converter, so the two agree
   bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .modules import LMConfig
from .util import unflatten_tree

_CTRL_PREFIX = "ctrl_encoder.ctrl_encoders."  # upstream's control encoder Linears


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """A nested dict -> {"a.b.c": leaf}: tensors as they are, any other
    array as numpy."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val if isinstance(val, torch.Tensor) else np.asarray(val)
    return out


def _leaf(x) -> torch.Tensor:
    """A flattened leaf as a CPU tensor in its own dtype."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def lm_state_dict_from_jax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A `VampNetLM` param tree -> the port's `VampNetLM` state dict. The
    tree's `ctrl_encoder` leaves go in only where `cfg` has `ctrl_dims`: an
    LM without them ignores the leaves, as the JAX package's does."""
    sd = {}
    for path, x in _flatten(params).items():
        if path.startswith("ctrl_encoder.") and not cfg.ctrl_dims:
            continue
        x = _leaf(x)
        site, leaf = path.rsplit(".", 1)
        if leaf == "kernel":
            sd[site + ".weight"] = x.float().T.contiguous()
        elif leaf == "kernel_q":
            sd[site + ".w_q"] = x.to(torch.int8).T.contiguous()
        elif leaf == "kernel_scale":
            sd[site + ".w_scale"] = x.float()
        else:
            sd[path] = x.float()
    return sd


def lm_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's `VampNetLM` state dict -> a flax-shaped nested dict of fp32
    numpy arrays (the inverse of `lm_state_dict_from_jax`): 2-D `.weight`s
    are Dense kernels and go back to (in, out) as `.kernel`; `w_q` goes back
    to an int8 (in, out) `kernel_q` and `w_scale` to `kernel_scale`."""
    tree: Dict = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        if leaf == "w_q":
            leaf, x = "kernel_q", val.detach().cpu().numpy().T
        else:
            x = val.detach().to(torch.float32).cpu().numpy()
        if leaf == "w_scale":
            leaf = "kernel_scale"
        elif leaf == "weight" and x.ndim == 2:
            leaf, x = "kernel", x.T
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(x)
    return tree


def codec_state_dict_from_jax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """An `LAC` param tree -> the port's `LAC` state dict (names only)."""
    sd = {path: _leaf(x).float() for path, x in _flatten(params).items()}
    n_quantizers = sum(1 for k in sd if k.endswith(".codebook"))
    if n_quantizers != cfg.n_codebooks:
        raise ValueError(f"param tree has {n_quantizers} quantizers, "
                         f"config says {cfg.n_codebooks}")
    return sd


# ---------------------------------------------------------------- torch checkpoints


def _load_torch_state_dict(path) -> Tuple[Dict[str, np.ndarray], dict]:
    """A torch checkpoint -> (numpy state dict, metadata). It unpickles the
    file (audiotools metadata is arbitrary Python), so load only trusted
    files, as with the JAX package's loader."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:
        raise ValueError(
            f"{path} is neither a native .vtpu checkpoint nor a loadable torch "
            f"checkpoint ({type(e).__name__}: {e})"
        ) from e
    metadata = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        metadata = obj.get("metadata", {}) or {}
        obj = obj["state_dict"]
    sd = {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "detach")}
    return sd, metadata


def _strip_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        for pref in ("module.", "_orig_mod."):
            while k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


def _collapse_wn(sd: Dict[str, np.ndarray], base: str) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse a torch weight-norm conv1d (g, v) to (W (out, in), bias)."""
    wv = sd[f"{base}.weight_v"][:, :, 0]
    wg = sd[f"{base}.weight_g"].reshape(-1)
    w = wg[:, None] * wv / np.linalg.norm(wv, axis=1, keepdims=True)
    return w, sd.get(f"{base}.bias")


def infer_lm_config(sd: Dict[str, np.ndarray], metadata: dict) -> LMConfig:
    """An `LMConfig` from the checkpoint's metadata kwargs, the rest inferred
    from the shapes (layers, width, codebooks, LoRA rank). As in the JAX
    converter, `ctrl_dims` stays unset where the file has a control
    encoder: the LM serves without it (`lm_state_dict_from_jax` leaves its
    leaves out), and a caller who wants the control LM sets `ctrl_dims`."""
    kwargs = dict(metadata.get("kwargs", {})) if metadata else {}
    n_layers = 0
    while f"transformer.layers.{n_layers}.norm_1.weight" in sd:
        n_layers += 1
    emb_dim = sd["transformer.norm.weight"].shape[0]
    n_codebooks, latent_dim = sd["embedding.special.MASK"].shape
    cls_out = (
        sd["classifier.layers.0.weight_v"].shape[0]
        if "classifier.layers.0.weight_v" in sd
        else sd["classifier.layers.0.weight"].shape[0]
    )
    lora_r = next((sd[k].shape[0] for k in sd if k.endswith("lora_A")), 0)
    vocab = int(kwargs.get("vocab_size", 1024))
    return LMConfig(
        n_heads=int(kwargs.get("n_heads", 20)),
        n_layers=n_layers,
        n_codebooks=n_codebooks,
        n_conditioning_codebooks=n_codebooks - cls_out // vocab,
        latent_dim=latent_dim,
        embedding_dim=emb_dim,
        vocab_size=vocab,
        dropout=float(kwargs.get("dropout", 0.1)),
        lora_r=lora_r,
    )


def lm_params_from_state_dict(sd: Dict[str, np.ndarray], cfg: LMConfig) -> Dict:
    """A prefix-free reference LM state dict -> a flax-shaped tree of CPU
    tensors."""
    flat: Dict[Tuple[str, ...], torch.Tensor] = {}

    def put(path, arr):
        flat[path] = torch.from_numpy(np.ascontiguousarray(arr))

    put(("embedding", "special_MASK"), sd["embedding.special.MASK"])
    put(("embedding", "out_proj", "kernel"), sd["embedding.out_proj.weight"][:, :, 0].T)
    put(("embedding", "out_proj", "bias"), sd["embedding.out_proj.bias"])

    if "classifier.layers.0.weight_v" in sd:
        w, b = _collapse_wn(sd, "classifier.layers.0")
    else:
        w, b = sd["classifier.layers.0.weight"][:, :, 0], sd.get("classifier.layers.0.bias")
    # reference channels are vocab-major ("b (p c) t"); the port's, like the
    # JAX package's, codebook-major
    n_out, v = w.shape[0], cfg.vocab_size
    n_pred = n_out // v
    perm = (np.arange(n_out) % v) * n_pred + (np.arange(n_out) // v)
    put(("classifier", "kernel"), w[perm].T)
    if b is not None:
        put(("classifier", "bias"), b[perm])

    def put_linear(ours, ref):
        put(ours + ("kernel",), sd[f"{ref}.weight"].T)
        if f"{ref}.lora_A" in sd and cfg.lora_r:
            put(ours + ("lora_a",), sd[f"{ref}.lora_A"].T)
            put(ours + ("lora_b",), sd[f"{ref}.lora_B"].T)

    for i in range(cfg.n_layers):
        p = f"transformer.layers.{i}"
        o = ("transformer", f"layers_{i}")
        put(o + ("norm_1", "weight"), sd[f"{p}.norm_1.weight"])
        put(o + ("norm_3", "weight"), sd[f"{p}.norm_3.weight"])
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            put_linear(o + ("self_attn", name), f"{p}.self_attn.{name}")
        if i == 0:
            put(o + ("self_attn", "relative_attention_bias"),
                sd[f"{p}.self_attn.relative_attention_bias.weight"])
        put_linear(o + ("feed_forward", "w_1"), f"{p}.feed_forward.w_1")
        put_linear(o + ("feed_forward", "w_2"), f"{p}.feed_forward.w_2")
    put(("transformer", "norm", "weight"), sd["transformer.norm.weight"])

    # the control encoder (sketch2sound), where the checkpoint has one
    for k in sd:
        if k.startswith(_CTRL_PREFIX):
            name = k.split(".")[2]
            if k.endswith(".weight"):
                put(("ctrl_encoder", f"ctrl_{name}", "kernel"), sd[k].T)
            elif k.endswith(".bias"):
                put(("ctrl_encoder", f"ctrl_{name}", "bias"), sd[k])
    return unflatten_tree(flat)


def lm_from_torch_checkpoint(path) -> Tuple[LMConfig, Dict]:
    sd, metadata = _load_torch_state_dict(path)
    sd = _strip_prefixes(sd)
    cfg = infer_lm_config(sd, metadata)
    return cfg, lm_params_from_state_dict(sd, cfg)


def lora_from_torch_checkpoint(path) -> Dict:
    """A loralib adapter-only state dict -> the `lora_a`/`lora_b` overlay
    tree."""
    sd = _strip_prefixes(_load_torch_state_dict(path)[0])
    flat: Dict[Tuple[str, ...], Any] = {}
    for k, v in sd.items():
        if not (k.endswith("lora_A") or k.endswith("lora_B")):
            continue
        parts = k.split(".")  # transformer.layers.0.self_attn.w_qs.lora_A
        if parts[0] != "transformer":
            raise ValueError(f"unexpected LoRA key {k}")
        leaf = "lora_a" if parts[-1] == "lora_A" else "lora_b"
        flat[("transformer", f"layers_{parts[2]}") + tuple(parts[3:-1]) + (leaf,)] = \
            torch.from_numpy(np.ascontiguousarray(v.T))
    return unflatten_tree(flat)
