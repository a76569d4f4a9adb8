"""w8a8 matmul for Hopper (`csrc/int8_matmul.cu`) and its plain PyTorch
version.

Replaces the Pallas kernel `_kernel` in `vampnet_tpu/ops/int8_matmul.py:36`
(`w8a8_matmul` `:52`), which the JAX package runs in every projection of
both LMs after `Interface.quantize()` (`w_qs`, `w_ks`, `w_vs`, `fc`, `w_1`,
`w_2`). The function, with every step in this order:

    a_scale = max(max_k |x|, 1e-8) * fp32(1/127)    per row, fp32
    xq      = clip(round_half_even(x / a_scale), -127, 127)   int8
    y       = ((float32(xq @ w_q^T) * a_scale) * w_scale).to(out_dtype)

The JAX source divides by 127.0; XLA compiles that division by a constant
into a product with the constant's fp32 reciprocal, on its XLA path and in
the Pallas kernel's interpreter alike, and the port computes what JAX
computes. The division by a_scale stays an IEEE division. The integer
product is exact in int32 (|sum| < 127^2 * 2560 < 2^31) and every float step
is one IEEE operation, so the kernel, its plain version and the JAX
package's XLA and Pallas paths agree bit for bit. `w_q` is (n, k), the
port's (out, in) weight layout; the JAX kernel's `kernel_q` is its transpose.

What bounds it on an H100 (1,979 TOP/s int8, 3.35 TB/s), at the serving
shapes (m = b*t = 1,724 coarse, 2,072 c2f):
  * q/k/v/fc, (k, n) = (1280, 1280): 2mkn = 5.65 G int-ops (2.9 us) against
    x, w_q and y, 10.5 MB (3.1 us): bound by bytes;
  * w_1, (1280, 5120): 22.6 G int-ops, 11.4 us: bound by operations;
  * w_2, (2560, 1280): 11.3 G int-ops, 5.7 us: bound by operations.

What the design does about it: the TPU kernel holds a row block's whole k in
VMEM for the absmax (128 rows x 2560 bf16 = 640 KB, more than an SM's
227 KB), so the wrapper launches two kernels back to back: a row-quant pass
writes xq and the row scales (2-5 MB; the IEEE quotient by Newton steps on
the FMA pipe), then a persistent warp-specialised GEMM (TMA-fed s8 `wgmma`
from a 3-5 stage ring, two consumer warpgroups, 128 x BN tiles with BN
chosen per (m, n) so the tiles fill whole waves of SMs; `block_n` reports
it) applies the dequant in its epilogue and stores through shared memory.
The GEMM starts by programmatic dependent launch, so its set-up and first
weight tiles overlap the quant's tail. The count `w8a8_matmul.launches`
goes up by one per call (the pair).
"""
from __future__ import annotations

import torch

from . import build

INV127 = 0.007874015718698502  # fp32(1 / 127), exact in fp32


def quantize_rows(x: torch.Tensor):
    """x (m, k) float -> (xq (m, k) int8, a_scale (m, 1) fp32): the dynamic
    per-row activation quantization, step for step as the JAX function."""
    a = x.float()
    amax = a.abs().amax(dim=-1, keepdim=True)
    a_scale = torch.clamp_min(amax, 1e-8) * INV127
    xq = torch.clamp(torch.round(a / a_scale), -127, 127).to(torch.int8)
    return xq, a_scale


def w8a8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (..., k) float, w_q (n, k)
    int8, w_scale (n,) fp32 -> (..., n) in `out_dtype`. The integer product
    runs in fp64, which holds every partial sum exactly (|sum| < 2^53), because
    `torch.matmul` takes no int8 on CUDA."""
    k = x.shape[-1]
    n = w_q.shape[0]
    xq, a_scale = quantize_rows(x.reshape(-1, k))
    acc = (xq.double() @ w_q.double().T).to(torch.int32)
    y = (acc.float() * a_scale * w_scale.float()[None, :]).to(out_dtype)
    return y.reshape(*x.shape[:-1], n)


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (..., k) bf16 or fp32, w_q (n, k) int8, w_scale (n,) fp32 ->
    (..., n) bf16 or fp32. CPU tensors take `w8a8_matmul_plain`; CUDA tensors
    launch the kernels (k a multiple of 16, n of 8) and count the call."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w_q, w_scale, out_dtype)
    build.refuse_grad("w8a8 matmul", x)
    k = x.shape[-1]
    n = w_q.shape[0]
    if not (w_q.device == x.device and w_scale.device == x.device):
        raise ValueError("x, w_q and w_scale must lie on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the w8a8 kernel takes bf16 or fp32 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the w8a8 kernel writes bf16 or fp32, not {out_dtype}")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[1] != k or not w_q.is_contiguous():
        raise ValueError(f"w_q must be a contiguous int8 ({n}, {k}) tensor, got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    if w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (n,) or not w_scale.is_contiguous():
        raise ValueError(f"w_scale must be a contiguous fp32 ({n},) tensor")
    if k % 16 or n % 8:
        raise ValueError(f"the w8a8 kernel needs k % 16 == 0 and n % 8 == 0, got k={k}, n={n}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if x2.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must be 16-byte aligned")
    # scratch: xq (m, k) int8, then a_scale (m,) fp32 at the next 16 bytes
    xq_bytes = (m * k + 15) // 16 * 16
    scratch = torch.empty((xq_bytes + 4 * m,), dtype=torch.uint8, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    xq = scratch.data_ptr()
    rc = build.library().vampnet_w8a8_matmul(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(), w_scale.data_ptr(),
        xq, xq + xq_bytes, out.data_ptr(), int(out_dtype == torch.bfloat16),
        m, n, k, x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "w8a8 matmul")
    w8a8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


w8a8_matmul.launches = 0


def block_n(m: int, n: int, device=None) -> int:
    """The GEMM's tile width (output columns per tile) at (m, n) on a CUDA
    device."""
    dev = torch.device("cuda" if device is None else device)
    return build.library().vampnet_w8a8_block_n(m, n, dev.index or 0)
