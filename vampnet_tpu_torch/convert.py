"""Weight bridge: the JAX package's flax param trees, given as nested dicts
of numpy arrays, to the port's state dicts, and (for the LM) back.

The port names its parameters after the flax tree (`layers_0`, `w_qs`,
`quantizers_3`, ...), so a flax path "a/b/kernel" becomes the key "a.b.weight"
and nothing is reordered:
  * Dense kernels are stored (in, out) by flax and (out, in) by
    `torch.nn.Linear`: they are transposed. The classifier keeps its
    codebook-major column order.
  * An int8-quantized LM (`quantize_lm_params` in the JAX package) carries
    `kernel_q` (in, out) int8 and `kernel_scale` (out,) fp32 at each
    projection; they become `w_q` (out, in) int8 and `w_scale` fp32.
  * The codec's weight-norm pairs carry over as they are: flax already
    stores v as (out, in, k) for a conv and (in, out, k) for a transposed
    conv, torch's layouts (the JAX layers transpose to WIO at call time).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def lm_state_dict_from_jax(params_np: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A `VampNetLM` param tree -> the port's `VampNetLM` state dict."""
    if cfg.lora_r != 0:
        raise NotImplementedError("LoRA adapters (r > 0) are not ported yet")
    sd = {}
    for path, x in _flatten(params_np).items():
        if path.endswith(".kernel"):
            sd[path[: -len("kernel")] + "weight"] = _tensor(x.T)
        elif path.endswith(".kernel_q"):
            sd[path[: -len("kernel_q")] + "w_q"] = torch.from_numpy(
                np.ascontiguousarray(x.T, dtype=np.int8))
        elif path.endswith(".kernel_scale"):
            sd[path[: -len("kernel_scale")] + "w_scale"] = _tensor(x)
        else:
            sd[path] = _tensor(x)
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


def codec_state_dict_from_jax(params_np: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """An `LAC` param tree -> the port's `LAC` state dict (names only)."""
    sd = {path: _tensor(x) for path, x in _flatten(params_np).items()}
    n_quantizers = sum(1 for k in sd if k.endswith(".codebook"))
    if n_quantizers != cfg.n_codebooks:
        raise ValueError(f"param tree has {n_quantizers} quantizers, "
                         f"config says {cfg.n_codebooks}")
    return sd
