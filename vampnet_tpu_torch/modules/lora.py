"""`LoRADense` (counterpart of `vampnet_tpu/modules/lora.py`), at rank 0.

A bias-free projection. In float it holds a `weight` carried across from the
JAX kernel (transposed, see `convert.py`) and computes in its compute dtype;
with `quantize=True` it holds an int8 `w_q` (out, in) and an fp32 `w_scale`
(out,) as buffers, the JAX `kernel_q`/`kernel_scale`, and runs the w8a8
matmul (`ops/int8_matmul.py`) on its input as given, as the JAX layer does.
Adapters (r > 0) are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_matmul import w8a8_matmul


class LoRADense(nn.Module):
    def __init__(self, in_features: int, out_features: int, r: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16, quantize: bool = False,
                 device=None):
        if r != 0:
            raise NotImplementedError("LoRA adapters (r > 0) are not ported yet")
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        if quantize:
            self.register_buffer(
                "w_q", torch.zeros((out_features, in_features), dtype=torch.int8, device=device))
            self.register_buffer(
                "w_scale", torch.ones((out_features,), dtype=torch.float32, device=device))
        else:
            self.weight = nn.Parameter(torch.empty((out_features, in_features), device=device))
            nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # nn.Linear's init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantize:
            return w8a8_matmul(x, self.w_q, self.w_scale, out_dtype=self.compute_dtype)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))
