"""`LoRADense` and the adapter-tree helpers (counterpart of
`vampnet_tpu/modules/lora.py`).

A bias-free projection. In float it holds a `weight` carried across from the
JAX kernel (transposed, see `convert.py`) and computes in its compute dtype;
with `quantize=True` it holds an int8 `w_q` (out, in) and an fp32 `w_scale`
(out,) as buffers, the JAX `kernel_q`/`kernel_scale`, and runs the w8a8
matmul (`ops/int8_matmul.py`) on its input as given, as the JAX layer does.

With rank r > 0 it also holds loralib's adapters under the flax names and
orientation, `lora_a` (in, r) and `lora_b` (r, out), and adds
(x A) B * alpha / r to the product, in the compute dtype, as the JAX layer
does (alpha = 1, as the JAX attention and FFN pass it). The adapter products
are small and run as plain matmuls. Init matches loralib: `lora_a`
He-uniform, `lora_b` zero, so a fresh adapter is a no-op.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_matmul import w8a8_matmul
from ..util import flatten_tree, unflatten_tree

LORA_R = 8  # the published models' rank (upstream vampnet/modules/transformer.py:22)
LORA_LEAVES = ("lora_a", "lora_b")


class LoRADense(nn.Module):
    def __init__(self, in_features: int, out_features: int, r: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16, quantize: bool = False,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        self.r = r
        if quantize:
            self.register_buffer(
                "w_q", torch.zeros((out_features, in_features), dtype=torch.int8, device=device))
            self.register_buffer(
                "w_scale", torch.ones((out_features,), dtype=torch.float32, device=device))
        else:
            self.weight = nn.Parameter(torch.empty((out_features, in_features), device=device))
            nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # nn.Linear's init
        if r > 0:
            self.scale = 1.0 / r  # alpha / r with alpha = 1
            self.lora_a = nn.Parameter(torch.empty((in_features, r), device=device))
            self.lora_b = nn.Parameter(torch.zeros((r, out_features), device=device))
            # flax's he_uniform: bound sqrt(6 / fan_in), fan_in = in_features
            nn.init.uniform_(self.lora_a, -math.sqrt(6 / in_features), math.sqrt(6 / in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.quantize:
            y = w8a8_matmul(x, self.w_q, self.w_scale, out_dtype=dt)
        else:
            y = F.linear(x.to(dt), self.weight.to(dt))
        if self.r > 0:
            xa = torch.matmul(x.to(dt), self.lora_a.to(dt))
            y = y + torch.matmul(xa, self.lora_b.to(dt)) * self.scale
        return y


def lora_param_filter(params: Mapping) -> Dict:
    """The tree of bools, True at the adapter leaves: which parameters a
    LoRA fine-tune trains."""
    return unflatten_tree({p: p[-1] in LORA_LEAVES for p in flatten_tree(params)})


def lora_state_dict(params: Mapping) -> Dict:
    """The adapter-only sub-tree of a flax-shaped param tree (what a
    LoRA-only checkpoint holds)."""
    return unflatten_tree({p: v for p, v in flatten_tree(params).items() if p[-1] in LORA_LEAVES})


def merge_lora_state_dict(params: Mapping, lora_params: Mapping) -> Dict:
    """Overlay an adapter-only tree onto a full param tree (of tensors):
    each leaf that the tree has is replaced, cast to its dtype; the others
    are ignored (the lenient load of upstream vampnet's interface)."""
    flat = flatten_tree(params)
    for path, leaf in flatten_tree(lora_params).items():
        if path in flat:
            flat[path] = torch.as_tensor(leaf).to(flat[path].dtype)
    return unflatten_tree(flat)
