"""`LoRADense` (counterpart of `vampnet_tpu/modules/lora.py`), at rank 0.

A bias-free projection whose weight is carried across from the JAX kernel
(transposed, see `convert.py`). Adapters (r > 0) are not ported yet."""
from __future__ import annotations

import torch

from .layers import Dense


class LoRADense(Dense):
    def __init__(self, in_features: int, out_features: int, r: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        if r != 0:
            raise NotImplementedError("LoRA adapters (r > 0) are not ported yet")
        super().__init__(in_features, out_features, bias=False,
                         compute_dtype=compute_dtype, device=device)
