"""The T5 position bias as an autograd Function whose backward sums the
bias's gradient into the bucket table with one kernel
(`csrc/relative_bias.cu`), and that backward's plain PyTorch version.

The forward gathers the (num_buckets, h) table into the (h, t_q, t_k) bias,
bias[h, i, j] = table[bucket(j - i), h], where `offset_buckets` holds the
bucket of every offset j - i at index j - i + t_q - 1. The backward is

    dtable[b, h] = sum over (i, j) with bucket(j - i) == b of dbias[h, i, j],

accumulated in fp32 and returned in the table's dtype. It replaces no TPU
kernel: in the JAX package XLA's scatter-add takes the gather's gradient
(`vampnet_tpu/modules/transformer.py:119-136`). Autograd's index backward,
which the port used before, sorts the t_q t_k indices and gives each bucket
to one warp; at t = 862 the two far buckets each hold about 297,000
positions, summed one after another. The kernel reads dbias once (59 MB at
20 heads and t = 862: bound by bytes) with every bucket's sum taken in a
fixed order, so a repeat gives the same bits.

`relative_bias_grad` takes the plain version for CPU tensors and the kernel
for CUDA tensors (or raises); `relative_bias_grad.launches` counts the
kernel's calls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build


def bucket_index(offset_buckets: torch.Tensor, t_q: int, t_k: int) -> torch.Tensor:
    """(t_q, t_k) bucket of every (i, j), read from the per-offset vector."""
    dev = offset_buckets.device
    rel = torch.arange(t_k, device=dev)[None, :] - torch.arange(t_q, device=dev)[:, None]
    return offset_buckets[rel + (t_q - 1)]


def relative_bias_grad_plain(dbias: torch.Tensor, offset_buckets: torch.Tensor,
                             num_buckets: int, dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dbias summed along its
    t_q + t_k - 1 diagonals, then each diagonal added into its bucket.

    The diagonals come from a skewed view: with the rows reversed and t_q
    zeros after each, row i' (= t_q - 1 - i) of the flat buffer read at the
    row length t_q + t_k - 1 holds dbias[i, j] at column j - i + t_q - 1,
    and zeros elsewhere. Each bucket then sums its diagonals (the others
    masked to 0) in one reduction, whose order is fixed for given shapes."""
    h, t_q, t_k = dbias.shape
    w = t_q + t_k - 1
    padded = F.pad(dbias.float().flip(1), (0, t_q))  # (h, t_q, t_k + t_q)
    skew = padded.reshape(h, -1)[:, :t_q * w].reshape(h, t_q, w)
    diagonals = skew.sum(dim=1)  # (h, w)
    one_hot = (offset_buckets.long()[None, :]
               == torch.arange(num_buckets, device=dbias.device)[:, None])  # (nb, w)
    return torch.where(one_hot[:, None, :], diagonals[None], 0.0).sum(dim=-1).to(dtype)


def relative_bias_grad(dbias: torch.Tensor, offset_buckets: torch.Tensor, num_buckets: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dbias (h, t_q, t_k) fp32 or bf16; offset_buckets (t_q + t_k - 1,)
    integer, each in [0, num_buckets) -> the (num_buckets, h) table gradient
    in `dtype` (fp32 or bf16), accumulated in fp32."""
    if dbias.dim() != 3 or offset_buckets.shape != (dbias.shape[1] + dbias.shape[2] - 1,):
        raise ValueError(f"dbias (h, t_q, t_k) and offset_buckets (t_q + t_k - 1,), got "
                         f"{tuple(dbias.shape)} and {tuple(offset_buckets.shape)}")
    if dbias.device.type == "cpu":
        return relative_bias_grad_plain(dbias, offset_buckets, num_buckets, dtype)
    if not dbias.is_cuda or offset_buckets.device != dbias.device:
        raise ValueError("dbias and offset_buckets must lie on one CUDA device")
    if dbias.dtype not in (torch.float32, torch.bfloat16) \
            or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the relative-bias gradient kernel takes and returns fp32 or bf16, "
                         f"got {dbias.dtype} -> {dtype}")
    if not 0 < num_buckets < 255:
        raise ValueError(f"the relative-bias gradient kernel takes 1 to 254 buckets, "
                         f"got {num_buckets}")
    h, t_q, t_k = dbias.shape
    dbias = dbias.contiguous()
    if dbias.data_ptr() % 16:
        dbias = dbias.clone()
    buckets = offset_buckets.to(torch.int32).contiguous()
    lib = build.library()
    partial = torch.empty((lib.vampnet_relative_bias_partials(h, t_q, num_buckets),),
                          dtype=torch.float32, device=dbias.device)
    out = torch.empty((num_buckets, h), dtype=dtype, device=dbias.device)
    stream = torch.cuda.current_stream(dbias.device).cuda_stream
    rc = lib.vampnet_relative_bias_grad(
        dbias.data_ptr(), int(dbias.dtype == torch.bfloat16), buckets.data_ptr(),
        partial.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16), h, t_q, t_k,
        num_buckets, dbias.device.index or 0, stream)
    build.check(rc, "relative-bias gradient")
    relative_bias_grad.launches += 1
    return out


relative_bias_grad.launches = 0


class RelativePositionBias(torch.autograd.Function):
    """table (num_buckets, h) and the per-offset buckets (t_q + t_k - 1,)
    -> the (h, t_q, t_k) bias, the gather, permute and contiguous copy of
    `position_bias_from_table`. Its backward is `relative_bias_grad`."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, offset_buckets: torch.Tensor, t_q: int,
                t_k: int) -> torch.Tensor:
        ctx.save_for_backward(offset_buckets)
        ctx.num_buckets, ctx.table_dtype = table.shape[0], table.dtype
        return table[bucket_index(offset_buckets, t_q, t_k)].permute(2, 0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (offset_buckets,) = ctx.saved_tensors
        return (relative_bias_grad(grad, offset_buckets, ctx.num_buckets, ctx.table_dtype),
                None, None, None)
