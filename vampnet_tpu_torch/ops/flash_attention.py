"""Attention kernels for Hopper (`csrc/attention_fwd.cu`,
`csrc/attention_bwd.cu`), their plain PyTorch versions, and the autograd
Function that makes attention trainable on the card.

All of them compute with the base-2 softmax of the Pallas kernels:
softmax_2(q_s k^T + b_2) v, where
  * q_s = bf16(q * scale * log2(e)), the product taken in fp32;
  * b_2 = bias * log2(e), rounded back to the bias dtype (bf16 or fp32),
    the bias head-shared (h, t, t);
  * keys past t are excluded (the JAX side pads them with -1e9);
  * with a mask (b, t, t), 0 = blocked, a blocked score is -1e9, the fill the
    JAX wrapper folds into its per-(b*h) bias (`flash_attention.py:913-921`),
    applied after the prefold as there;
  * QK^T and PV accumulate in fp32, P enters PV as bf16, and the division by
    the row sum comes after PV.
A row whose every key is blocked averages v over its t keys, as the JAX XLA
path does (its Pallas path averages over the padded length instead, because
its padding and its mask share the -1e9); its gradient is XLA's too: dv gets
do / t and nothing reaches q, k or the bias through a blocked score.
The layout is the port's public one, (b, t, h, d). The kernels are built for
d = 64 and d = 128; the wrappers zero-pad q, k, v (and do) up to the next of
the two and slice the results back, keeping the scale of the unpadded d, so
any d <= 128 runs, as on every JAX route (the JAX wrapper pads d to 128
lanes). Zero columns change no score and no output column that is kept. The
bias is bf16 (the serving LMs' T5 table) or fp32, on every kernel; dbias
comes back in the bias's dtype. The kernels apply both prefolds themselves as
they load q and the bias, and the mask as they form each score, so callers
pass the raw q, bias and mask, and no prefolded or per-(b*h) bias is ever
written.

Inference, through `flash_attention_with_bias` when no input needs a
gradient. It routes as the JAX wrapper does, and each route counts its own
launches:
  * `attention_fwd` (K1): no mask, t <= `MAX_SINGLE_PASS_SEQ`. Replaces
    `_attn_kernel_dt` (`vampnet_tpu/ops/flash_attention.py:120`), which every
    layer of every MaskGIT step runs on the TPU, and `_attn_kernel` (`:93`)
    where JAX takes it without a mask (896 < t <= 1024, q blocks of 128).
    Per coarse serving call (b=2, t=862, h=20, d=64) q, k, v and o are
    4 x 4.41 MB of bf16 and the bias 29.7 MB in bf16: 47.4 MB, 14 us at
    3.35 TB/s, against 7.6 GFLOP, 8 us at 989 TFLOP/s. So the bias read
    bounds it; the kernel reads it from device memory about once per head.
  * `attention_fwd_masked` (K3): a mask, t <= `MAX_SINGLE_PASS_SEQ`.
    Replaces `_attn_kernel` (`:93`) over the per-(b*h) bias. The same
    kernel reads the head-shared bias and the batch row's mask bytes. At the
    coarse training shape (b=8, t=862, fp32 bias) a materialised per-(b*h)
    fp32 bias would be 475 MB a layer; the mask is 5.9 MB.
  * `attention_fwd_long` (K9): t > `MAX_SINGLE_PASS_SEQ`, with or without a
    mask. Replaces the blocked online-softmax `_attn_kernel_blocked`
    (`:47`). The K1 kernel streams keys with an online softmax and has no
    upper t, so it is the same kernel. At b=2, t=1,723, h=20 with a bf16
    bias: q, k, v, o 35 MB and the bias 119 MB, 46 us if the bias is read
    once, against 30.4 GFLOP, 31 us: bound by bytes.

Without a bias or a mask (MAGNeT's layers), the inference forward takes
the kernel's no-bias instances (`vampnet_attention_fwd_nobias`), which
allocate and read no bias: k and v may hold t_k != t keys (cross-attention
over a text), and `window` w keeps only the keys with |i - j| <= w (the
restricted context), loading only the key tiles of the band. Such short
items run persistent, one block an SM. At (16, 1,500, 24, 64) on an H100:
full 0.74 ms (bound 0.22, operations), w = 5 0.13 ms (bound 0.088, bytes),
t_k = 64 0.074 ms (bound 0.046); `chip_smoke.py`'s `magnet_kernels_phase`.

Training, the `_AttentionCore` Function (the counterpart of the JAX custom
VJP `_attention_core`, `flash_attention.py:546-848`), at every t:
  * forward `attention_fwd_lse` (`attention_fwd_lse_masked` with a mask):
    replaces `_attn_kernel_fwd_lse` (`:254`) and its (d,t)-major twin
    `_attn_kernel_fwd_lse_dt` (`:153`), whose out and lse are the same. The
    inference kernel, also writing lse = m + log2(l) per query row in fp32,
    (b*h, t).
  * backward `attention_bwd`: delta = rowsum(do * out) in torch (XLA in the
    JAX package, `:600-602`), then one launch of `attention_bwd_fused`
    (`attention_bwd_fused_masked` with a mask): dq, dk, dv and the
    batch-summed dbias in one pass of 5 score-sized products. It computes
    the function of the one-pass `_attn_kernel_bwd_wholeseq` (`:428`), which
    the JAX package takes at b <= 8, and so of the split pair
    `_attn_kernel_bwd_dkdv` (`:336`) and `_attn_kernel_bwd_dq_dbias`
    (`:381`) that it takes above (a choice about TPU VMEM; the card takes
    the one pass at every batch). With a mask it replaces `_attn_kernel_bwd`
    (`:279`), which JAX runs over the per-(b*h) bias and whose per-(b*h)
    dbias its chain rule then sums over the batch; here dbias stays
    head-shared and is summed over the batch in a fixed order, with the
    roundings of the unmasked route.
  At the coarse training shape (b=8, t=862, h=20, d=64, fp32 bias) the
  forward's 2 products are 30.4 GFLOP (31 us at 989 TFLOP/s) and it moves
  about 130 MB if the bias is read once (39 us): bound by bytes. The
  backward's 5 products are 76.1 GFLOP (77 us) against 243.6 MB moved
  (73 us): bound by operations, just. At b=1, t=2,048 the bias read and
  dbias written (671 MB, 200 us) bound the backward by bytes. The forward's
  blocks read the bias in L2 once per head; the backward reads it once per
  batch row and writes dbias once. A mask adds 5.9 MB.

What the design does about the TPU's layout: the TPU kernels hold a whole
(t_p, t_p) score tile per program in up to 100 MB of VMEM; an SM has 227 KB.
So both kernels here stream 64-row tiles, warp specialised for Hopper: a
producer warpgroup keeps a ring of tiles in flight (bf16 tiles by TMA from
4-D tensor maps, so rows past t arrive as zeros; the bias and mask tiles by
TMA where a row of t elements is a multiple of 16 bytes, else a bulk copy
per bias row and 16-byte cp.async for the mask) and two consumer
warpgroups run the products on `wgmma`, the score accumulator seeded with
the prefolded bias. The forward: a block owns 128 query rows of one (batch
row, head) and streams key tiles with an online softmax (O += P V with P in
registers); the blocks of one (head, query tile) are launched together, the
batch row innermost, so L2 serves the bias strip to all but the first. The
backward: a block owns 64 keys of one head and walks the batch rows and, in
each, the query tiles, which the two consumers take in turn; with the keys
as the wgmma rows, P^T and dS^T stay in registers for dV += P^T dO and
dK += dS^T Q_s, dS^T goes to shared memory for dQ's part dS K, which a TMA
reduce-add adds into an fp32 buffer (no scalar atomics; dq's summation
order across key tiles is not fixed), and each dbias entry is summed over
the batch by one thread in a fixed order. dk, dv and dbias are bitwise
reproducible.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIMS = (64, 128)  # the head dims the kernels are built for
MAX_SINGLE_PASS_SEQ = 1024  # JAX's switch to the blocked forward (K9)
MASKED_SCORE = -1e9  # a blocked score, in the prefolded base-2 units
# the lse of a row with no open key is -1e9 + log2(t), -1e9 in fp32
FULLY_BLOCKED_LSE = -5e8


def _acc(x: torch.Tensor) -> torch.dtype:
    """The accumulation dtype: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _q_scale(q: torch.Tensor, q_scale: Optional[float]) -> float:
    """log2(e) / sqrt(d), the q prefold's factor, unless given (a padded q
    keeps the factor of its unpadded head dim)."""
    return LOG2E / math.sqrt(q.shape[-1]) if q_scale is None else q_scale


def _prefold(q: torch.Tensor, bias: Optional[torch.Tensor], q_scale: Optional[float] = None):
    """q_s = q * scale * log2(e) and b_2 = bias * log2(e), each product in
    (at least) fp32 and rounded back to the input's dtype."""
    qs = (q.to(_acc(q)) * _q_scale(q, q_scale)).to(q.dtype)
    b2 = None if bias is None else (bias.to(_acc(bias)) * LOG2E).to(bias.dtype)
    return qs, b2


def attention_mask(mask: Optional[torch.Tensor], q: torch.Tensor) -> Optional[torch.Tensor]:
    """A mask (b, t, t) or (b, 1, t, t) of any dtype, 0 = blocked, as the
    contiguous bool (b, t, t) tensor the kernels read as bytes; None stays
    None. A mask of another shape, or on another device than q, is refused."""
    if mask is None:
        return None
    b, t = q.shape[:2]
    if mask.dim() == 4 and mask.shape[1] == 1:
        mask = mask[:, 0]
    if tuple(mask.shape) != (b, t, t):
        raise ValueError(f"mask must be ({b}, {t}, {t}) or ({b}, 1, {t}, {t}), "
                         f"got {tuple(mask.shape)}")
    if mask.device != q.device:
        raise ValueError(f"mask lies on {mask.device}, q on {q.device}")
    return (mask if mask.dtype == torch.bool else mask != 0).contiguous()


def band(t_q: int, t_k: int, window: int, device) -> torch.Tensor:
    """(t_q, t_k) bool: True where |i - j| <= window."""
    rel = torch.arange(t_k, device=device)[None, :] - torch.arange(t_q, device=device)[:, None]
    return rel.abs() <= window


def _scores(qs, k, b2, mask=None, window: Optional[int] = None):
    """s = q_s k^T + b_2 in the accumulation dtype, (b, h, t_q, t_k), -1e9
    where the mask blocks, and -inf (no weight at all) outside the window."""
    acc = _acc(qs)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.to(acc), k.to(acc))
    s = s if b2 is None else s + b2.to(acc)[None]
    if mask is not None:
        s = torch.where(mask[:, None], s, torch.tensor(MASKED_SCORE, dtype=acc, device=s.device))
    if window is not None:
        s = s.masked_fill(~band(s.shape[2], s.shape[3], window, s.device), float("-inf"))
    return s


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        q_scale: Optional[float] = None,
                        mask: Optional[torch.Tensor] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """The inference kernels' function in plain PyTorch, step for step as the
    Pallas path computes it (prefolds, base-2 softmax, normalise after PV).
    k and v may hold another number of keys than q has queries (no bias or
    mask then); `window` w keeps only the keys with |i - j| <= w."""
    return attention_fwd_lse_plain(q, k, v, bias, q_scale, mask, window)[0]


def attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            q_scale: Optional[float] = None,
                            mask: Optional[torch.Tensor] = None,
                            window: Optional[int] = None):
    """K4's function: (out (b, t, h, d) in v's dtype, lse (b*h, t) in fp32),
    lse the base-2 log-sum-exp of each query row's scores."""
    b, t, h, _ = q.shape
    qs, b2 = _prefold(q, bias, q_scale)
    s = _scores(qs, k, b2, attention_mask(mask, q), window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)  # (b, h, q, 1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(s.dtype), v.to(s.dtype))
    out = (acc / l.permute(0, 2, 1, 3)).to(v.dtype)
    return out, (m + torch.log2(l)).reshape(b * h, t)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * out) in (at least) fp32, (b*h, t)."""
    b, t, h, _ = out.shape
    acc = _acc(out)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)  # (b, t, h)
    return delta.permute(0, 2, 1).reshape(b * h, t).contiguous()


def _probs_and_ds(q, k, v, bias, lse, do, delta, q_scale=None, mask=None):
    """The backward's recompute: q_s, P = exp2(s - lse) and
    dS = P (do v^T - delta) ln 2, the last two (b, h, t_q, t_k). Where the
    mask blocks, dS is 0 and P is 0, or 1/t in a row with no open key."""
    b, t, h, _ = q.shape
    mask = attention_mask(mask, q)
    qs, b2 = _prefold(q, bias, q_scale)
    s = _scores(qs, k, b2, mask)
    lse = lse.reshape(b, h, t, 1).to(s.dtype)
    p = torch.exp2(s - lse)
    if mask is not None:
        blocked = ~mask[:, None]
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        p = torch.where(blocked, torch.where(lse < FULLY_BLOCKED_LSE, zero + 1.0 / t, zero), p)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(s.dtype), v.to(s.dtype))
    ds = p * (dp - delta.reshape(b, h, t, 1).to(s.dtype)) * LN2
    if mask is not None:
        ds = torch.where(blocked, zero, ds)
    return qs, p, ds


def attention_bwd_dkdv_plain(q, k, v, bias, lse, do, delta, q_scale=None, mask=None):
    """K6's function (K5's dk and dv with a mask): dk = dS^T q_s and
    dv = P^T do, with P and dS cast to the input dtype for the products."""
    qs, p, ds = _probs_and_ds(q, k, v, bias, lse, do, delta, q_scale, mask)
    acc = p.dtype
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), do.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc), qs.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_dq_dbias_plain(q, k, v, bias, lse, do, delta, q_scale=None, mask=None):
    """K7's function (K5's dq and dbias with a mask, the batch summed) with
    the prefolds' chain rule: dq = (dS k) * scale *
    log2(e) and dbias = sum over the batch of dS, times log2(e), in the
    bias's dtype (or None without a bias). As in the JAX VJP, the batch sum
    is cast to the bias's dtype before the log2(e) factor (in fp32) and after
    it: two roundings for a bf16 bias, none for an fp32 one."""
    _qs, p, ds = _probs_and_ds(q, k, v, bias, lse, do, delta, q_scale, mask)
    acc = p.dtype
    dqs = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).to(acc), k.to(acc)).to(q.dtype)
    dq = (dqs.to(acc) * _q_scale(q, q_scale)).to(q.dtype)
    dbias = None
    if bias is not None:
        dbias = (ds.sum(dim=0).to(bias.dtype).to(acc) * LOG2E).to(bias.dtype)
    return dq, dbias


def attention_bwd_fused_plain(q, k, v, bias, lse, do, delta, mask=None):
    """The backward kernel's function (K8's; K5's with a mask): (dq, dk, dv,
    dbias), the two plain halves above on one delta."""
    dk, dv = attention_bwd_dkdv_plain(q, k, v, bias, lse, do, delta, mask=mask)
    dq, dbias = attention_bwd_dq_dbias_plain(q, k, v, bias, lse, do, delta, mask=mask)
    return dq, dk, dv, dbias


def attention_bwd_plain(q, k, v, bias, out, lse, do, mask=None):
    """(dq, dk, dv, dbias) of softmax_2(q_s k^T + b_2) v at the raw q and
    bias, from the forward's out and lse."""
    return attention_bwd_fused_plain(q, k, v, bias, lse, do, attention_delta(out, do), mask)


# ------------------------------------------------------------- kernel wrappers


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim d at: the smallest of
    `HEAD_DIMS` that holds it."""
    for dk in HEAD_DIMS:
        if d <= dk:
            return dk
    raise ValueError(f"the attention kernels take a head dim up to {HEAD_DIMS[-1]}, got {d}")


def pad_head(x: torch.Tensor, dk: int) -> torch.Tensor:
    """x (..., d) zero-padded to (..., dk), contiguous."""
    d = x.shape[-1]
    return x.contiguous() if d == dk else F.pad(x, (0, dk - d))


def _check(q, k, v, bias):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernels take bf16 q/k/v, got {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (b, t, h, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    kernel_head_dim(d)
    if bias is not None:
        if bias.device != q.device or bias.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("bias must be a bf16 or fp32 tensor on q's device")
        if tuple(bias.shape) != (h, t, t) or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous ({h}, {t}, {t}) tensor, "
                             f"got {tuple(bias.shape)}")


def _padded(q, *xs):
    """(kernel head dim, the scale of the unpadded one, the tensors padded).
    Every padded tensor is a fresh contiguous one or a contiguous input."""
    d = q.shape[-1]
    dk = kernel_head_dim(d)
    out = [pad_head(x, dk) for x in (q, *xs)]
    for x in out:
        if x.data_ptr() % 16:
            raise ValueError("the attention kernels need 16-byte aligned tensors")
    return dk, LOG2E / math.sqrt(d), out


def _check_rows(name, x, b, t, h):
    if x.dtype != torch.float32 or tuple(x.shape) != (b * h, t) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 ({b * h}, {t}) tensor")


def _bias_or_zeros(bias, q):
    b, t, h, _ = q.shape
    if bias is None:
        return torch.zeros((h, t, t), dtype=torch.float32, device=q.device)
    return bias


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _mask_ptr(mask):
    return 0 if mask is None else mask.data_ptr()


def _check_nobias(q, k, v, window):
    """q (b, t_q, h, d) and k, v (b, t_k, h, d) bf16 on one CUDA device; a
    window needs t_k = t_q."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernels take bf16 q/k/v, got {q.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q (b, t_q, h, d) and k, v (b, t_k, h, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    kernel_head_dim(q.shape[-1])
    if window is not None and (window < 0 or k.shape[1] != q.shape[1]):
        raise ValueError(f"a window w >= 0 needs as many keys as queries, got w={window}, "
                         f"t_q={q.shape[1]}, t_k={k.shape[1]}")


def _launch_fwd(q, k, v, bias, mask, with_lse: bool, window: Optional[int] = None):
    """One launch of the forward kernel (with lse rows or without) on CUDA
    tensors; mask None or a contiguous bool (b, t, t) on q's device. Without
    a bias, a mask or lse rows it takes the kernel's no-bias instances,
    which read no bias, take k and v of another length than q, and a
    window."""
    what = "attention forward-with-lse" if with_lse else "attention"
    build.refuse_grad(what, q, k, v, bias)
    b, t, h, d = q.shape
    lib = build.library()
    if bias is None and mask is None and not with_lse:
        _check_nobias(q, k, v, window)
        dk, q_scale, (qp, kp, vp) = _padded(q, k, v)
        out = torch.empty_like(qp)
        build.check(lib.vampnet_attention_fwd_nobias(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), b, t, k.shape[1], h, dk,
            -1 if window is None else int(window), q_scale, q.device.index or 0, _stream(q)),
            what)
        return out[..., :d]
    if window is not None:
        raise ValueError("a window is taken only without a bias, a mask or lse rows")
    _check(q, k, v, bias)
    dk, q_scale, (qp, kp, vp) = _padded(q, k, v)
    bias = _bias_or_zeros(bias, q)
    out = torch.empty_like(qp)
    flags = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), bias.data_ptr(),
             int(bias.dtype == torch.bfloat16), _mask_ptr(mask), out.data_ptr())
    tail = (b, t, h, dk, q_scale, q.device.index or 0, _stream(q))
    if with_lse:
        lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
        build.check(lib.vampnet_attention_fwd_lse(*flags, lse.data_ptr(), *tail), what)
        return out[..., :d], lse
    build.check(lib.vampnet_attention_fwd(*flags, *tail), what)
    return out[..., :d]


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """The inference kernel (K1): q, k, v (b, t, h, d <= 128) bf16, bias
    (h, t, t) bf16 or fp32 or None. Without a bias, k and v may be
    (b, t_k, h, d) (cross-attention) and `window` w keeps the keys with
    |i - j| <= w; nothing of a bias is then allocated or read. Forward-only.
    CPU tensors take `attention_fwd_plain`; CUDA tensors launch the kernel
    and count the launch on `flash_attention_with_bias.launches`."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, bias, window=window)
    out = _launch_fwd(q, k, v, bias, None, with_lse=False, window=window)
    flash_attention_with_bias.launches += 1
    return out


def attention_fwd_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """The masked inference forward (K3): as `attention_fwd`, with a mask
    (b, t, t) or (b, 1, t, t), 0 = blocked. Counts on its own `launches`."""
    mask = attention_mask(mask, q)
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, bias, mask=mask)
    out = _launch_fwd(q, k, v, bias, mask, with_lse=False)
    attention_fwd_masked.launches += 1
    return out


def attention_fwd_long(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       mask: Optional[torch.Tensor] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """The inference forward past `MAX_SINGLE_PASS_SEQ` (K9), with or without
    a mask: the K1 kernel, whose key loop has no upper t; without a bias or
    mask, with K1's cross-attention and window. Counts on its own
    `launches`."""
    mask = attention_mask(mask, q)
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, bias, mask=mask, window=window)
    out = _launch_fwd(q, k, v, bias, mask, with_lse=False, window=window)
    attention_fwd_long.launches += 1
    return out


def attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor] = None):
    """The training forward (K4): (out, lse (b*h, t) fp32); the bias bf16 or
    fp32. CPU tensors take `attention_fwd_lse_plain`."""
    if q.device.type == "cpu":
        return attention_fwd_lse_plain(q, k, v, bias)
    res = _launch_fwd(q, k, v, bias, None, with_lse=True)
    attention_fwd_lse.launches += 1
    return res


def attention_fwd_lse_masked(q, k, v, bias, mask):
    """The training forward with a mask (K4's function over K3's masked
    scores). Counts on its own `launches`."""
    mask = attention_mask(mask, q)
    if q.device.type == "cpu":
        return attention_fwd_lse_plain(q, k, v, bias, mask=mask)
    res = _launch_fwd(q, k, v, bias, mask, with_lse=True)
    attention_fwd_lse_masked.launches += 1
    return res


def _check_bwd(q, k, v, bias, lse, do, delta):
    build.refuse_grad("attention backward", q, k, v, bias, lse, do, delta)
    _check(q, k, v, bias)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("do must be a bf16 tensor of q's shape on q's device")
    b, t, h, _ = q.shape
    _check_rows("lse", lse, b, t, h)
    _check_rows("delta", delta, b, t, h)


def _launch_bwd(q, k, v, bias, lse, do, delta, mask):
    """One launch of the backward kernel on CUDA tensors: (dq, dk, dv, dbias
    or None)."""
    _check_bwd(q, k, v, bias, lse, do, delta)
    b, t, h, d = q.shape
    dk_, q_scale, (qp, kp, vp, dop) = _padded(q, k, v, do)
    bias_in = _bias_or_zeros(bias, q)
    dq_acc = torch.zeros(qp.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    dbias = torch.empty((h, t, t), dtype=bias_in.dtype, device=q.device)
    # the kernel's 64-row query tiles: each tile's lse and delta rows side by
    # side, (b*h, T/64, 2, 64) with T = t rounded up to 64, zeros past t, so
    # that one 512-byte copy brings them; and, which one batch row does not
    # need, the running batch sums of dbias, (h, T, T) fp32, followed by a
    # cache of the prefolded bias, (h, T, T) in the bias dtype
    t_pad = -(-t // 64) * 64
    rows = torch.zeros((b * h, 2, t_pad), dtype=torch.float32, device=q.device)
    rows[:, 0, :t] = lse
    rows[:, 1, :t] = delta
    rows = rows.view(b * h, 2, t_pad // 64, 64).transpose(1, 2).contiguous()
    part = None
    if b > 1:
        part = torch.empty(h * t_pad * t_pad * (4 + bias_in.element_size()) // 4,
                           dtype=torch.float32, device=q.device)
    rc = build.library().vampnet_attention_bwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), bias_in.data_ptr(),
        int(bias_in.dtype == torch.bfloat16), _mask_ptr(mask), rows.data_ptr(), dop.data_ptr(),
        dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
        0 if part is None else part.data_ptr(), b, t, h, dk_, q_scale,
        q.device.index or 0, _stream(q),
    )
    build.check(rc, "attention backward")
    return dq_acc[..., :d].to(q.dtype), dk[..., :d], dv[..., :d], None if bias is None else dbias


def attention_bwd_fused(q, k, v, bias, lse, do, delta):
    """The backward kernel (K6/K7, K8's one pass): (dq, dk, dv in bf16,
    dbias (h, t, t) in the bias's dtype, or None). CPU tensors take
    `attention_bwd_fused_plain`."""
    if q.device.type == "cpu":
        return attention_bwd_fused_plain(q, k, v, bias, lse, do, delta)
    res = _launch_bwd(q, k, v, bias, lse, do, delta, None)
    attention_bwd_fused.launches += 1
    return res


def attention_bwd_fused_masked(q, k, v, bias, lse, do, delta, mask):
    """The backward kernel with a mask (K5; its dbias summed over the batch).
    Counts on its own `launches`."""
    mask = attention_mask(mask, q)
    if q.device.type == "cpu":
        return attention_bwd_fused_plain(q, k, v, bias, lse, do, delta, mask)
    res = _launch_bwd(q, k, v, bias, lse, do, delta, mask)
    attention_bwd_fused_masked.launches += 1
    return res


def attention_bwd(q, k, v, bias, out, lse, do, mask=None):
    """(dq, dk, dv, dbias): delta in torch, then one launch of the backward
    kernel, the masked route where there is a mask (or, for CPU tensors, the
    plain versions)."""
    delta = attention_delta(out, do)
    if mask is None:
        return attention_bwd_fused(q, k, v, bias, lse, do, delta)
    return attention_bwd_fused_masked(q, k, v, bias, lse, do, delta, mask)


for _wrapper in (attention_fwd_masked, attention_fwd_long, attention_fwd_lse,
                 attention_fwd_lse_masked, attention_bwd_fused, attention_bwd_fused_masked):
    _wrapper.launches = 0


class _AttentionCore(torch.autograd.Function):
    """softmax_2(q_s k^T + b_2) v, differentiable in q, k, v and the bias;
    the mask (None or bool (b, t, t)) is not differentiable. The forward
    saves (q, k, v, bias, mask, out, lse); the kernels redo the prefolds as
    they load q and the bias, bit for bit as the forward did, so q_s and b_2
    are never stored."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        if mask is None:
            out, lse = attention_fwd_lse(q, k, v, bias)
        else:
            out, lse = attention_fwd_lse_masked(q, k, v, bias, mask)
        ctx.save_for_backward(q, k, v, bias, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask, out, lse = ctx.saved_tensors
        return (*attention_bwd(q, k, v, bias, out, lse, do.contiguous(), mask), None)


def flash_attention_with_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              mask: Optional[torch.Tensor] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (b, t, h, d <= 128); bias: (h, t, t) or None; mask: (b, t, t)
    or (b, 1, t, t), 0 = blocked, or None. Without a bias or a mask, k and v
    may hold t_k != t keys (cross-attention) and `window` w keeps only the
    keys with |i - j| <= w (inference only). When grad mode is on and an
    input requires grad, the call goes through `_AttentionCore` (kernels on
    the card at every t, plain versions on the CPU); otherwise through the
    inference route: `attention_fwd_long` past `MAX_SINGLE_PASS_SEQ`,
    `attention_fwd_masked` with a mask, `attention_fwd` without."""
    mask = attention_mask(mask, q)
    if build.needs_grad(q, k, v, bias):
        if window is not None or k.shape[1] != q.shape[1]:
            raise ValueError("the training kernels take neither a window nor t_k != t_q")
        return _AttentionCore.apply(q, k, v, bias, mask)
    if q.shape[1] > MAX_SINGLE_PASS_SEQ:
        return attention_fwd_long(q, k, v, bias, mask, window)
    if mask is not None:
        if window is not None:
            raise ValueError("a window is taken only without a bias or a mask")
        return attention_fwd_masked(q, k, v, bias, mask)
    return attention_fwd(q, k, v, bias, window)


flash_attention_with_bias.launches = 0
