"""Post-training int8 weight quantization for the LM (counterpart of
`vampnet_tpu/modules/quantize.py`).

The q/k/v/out and FFN projections switch to w8a8: int8 weights with
per-output-channel symmetric scales, the activations quantized per row
inside the matmul (`LoRADense(quantize=True)`, `ops/int8_matmul.py`). The
embedding projection and the classifier stay in the float dtype, as in the
JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

# module names whose `weight` is quantized (the LoRADense sites)
QUANT_MODULES = ("w_qs", "w_ks", "w_vs", "fc", "w_1", "w_2")


def quantize_kernel(weight: torch.Tensor):
    """A float weight (out, in) -> (int8 w_q (out, in), fp32 w_scale (out,)):
    scale = max(|w|, over in) / 127 floored at 1e-12, w_q = clip(round half to
    even(w / scale), -127, 127), all in fp32 as the JAX function computes it
    on the transposed (in, out) kernel."""
    w = weight.detach().to(torch.float32)
    scale = torch.clamp_min(w.abs().amax(dim=1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_lm_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Replace `<site>.weight` at every `QUANT_MODULES` site with `<site>.w_q`
    and `<site>.w_scale`; every other entry passes through."""
    out = {}
    for key, val in state_dict.items():
        path = key.split(".")
        if path[-1] == "weight" and len(path) >= 2 and path[-2] in QUANT_MODULES:
            prefix = key[: -len("weight")]
            out[prefix + "w_q"], out[prefix + "w_scale"] = quantize_kernel(val)
        else:
            out[key] = val
    return out
