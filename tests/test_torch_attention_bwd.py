"""Port parity: the training attention. The plain versions of the
forward-with-lse kernel and of the backward kernels, and the autograd Function
that carries them, against the JAX package's Pallas kernels (run in interpret
mode) and its custom VJP `_attention_core`.

t = 77 and t = 150 are not multiples of 128, so the JAX side pads keys (with
a -1e9 bias) and the port excludes them itself: the key mask is exercised.
The routes of the JAX VJP are each reached: K4 (default forward), K2 (the
(d,t)-major forward, `_DT_TRAIN_FWD`), K8 (whole-sequence backward) and the
K6/K7 pair (`block_q=64`, so the padded length 256 exceeds the q block).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampnet_tpu.ops import flash_attention as jfa
from vampnet_tpu_torch.ops import build
from vampnet_tpu_torch.ops.flash_attention import (
    LOG2E,
    attention_bwd_dkdv,
    attention_bwd_dkdv_plain,
    attention_bwd_dq_dbias,
    attention_bwd_dq_dbias_plain,
    attention_bwd_plain,
    attention_delta,
    attention_fwd_lse,
    attention_fwd_lse_plain,
    flash_attention_with_bias,
    kernel_head_dim,
    pad_head,
)

H, D = 2, 64


def _inputs(b, t, seed, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, H, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, t, t)).astype(np.float32)
    w = rng.standard_normal((b, t, H, d)).astype(np.float32)  # d loss / d out
    return q, k, v, bias, w


def _jax_padded(q, k, v, bias):
    """The padded, prefolded (bh, tp, dp) arrays that the JAX
    `flash_attention_with_bias` hands its kernels (whole-sequence block)."""
    b, t, h, d = q.shape
    tp, dp = jfa._round_up(t, 128), jfa._round_up(d, 128)
    q = (q.astype(jnp.float32) * (LOG2E / d ** 0.5)).astype(q.dtype)

    def pad(x):
        x = jnp.transpose(x, (0, 2, 1, 3)).reshape(b * h, t, d)
        return jnp.pad(x, ((0, 0), (0, tp - t), (0, dp - d)))

    bias_p = jnp.pad((bias.astype(jnp.float32) * LOG2E).astype(jnp.float32),
                     ((0, 0), (0, tp - t), (0, tp - t)))
    bias_p = jnp.where((jnp.arange(tp) >= t)[None, None, :], -1e9, bias_p)
    return pad(q), pad(k), pad(v), bias_p, tp


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


@pytest.mark.parametrize("route", ["K4", "K2"])
@pytest.mark.parametrize("t", [77, 150])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_lse_plain_matches_pallas(route, t, dtype):
    b = 2
    q, k, v, bias, _ = _inputs(b, t, seed=t)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    qp, kp, vp, bias_p, tp = _jax_padded(jq, jk, jv, jnp.asarray(bias))
    if route == "K4":
        out, lse = jfa._fwd_call(qp, kp, vp, bias_p, tp, H, True, with_lse=True)
    else:
        out, lse = jfa._fwd_call_dt(qp, kp, vp, bias_p, H, D, True, with_lse=True)
    want_out = np.asarray(out[:, :t, :D].astype(jnp.float32)).reshape(b, H, t, D)
    want_out = want_out.transpose(0, 2, 1, 3)
    want_lse = np.asarray(lse[:, 0, :t])

    tdt = getattr(torch, dtype)
    tq, tk, tv = (_t(np.asarray(x.astype(jnp.float32)), tdt) for x in (jq, jk, jv))
    got_out, got_lse = attention_fwd_lse_plain(tq, tk, tv, _t(bias))
    assert got_out.dtype == tdt and got_lse.dtype == torch.float32
    assert tuple(got_lse.shape) == (b * H, t)
    if dtype == "float32":
        # the same base-2 steps; fp32 summation order only
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        # the same roundings in the same places; the fp32 sums differ in
        # order, which can move a bf16 output by one ulp (2^-8 relative)
        tol = dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got_out.float().numpy(), want_out, **tol)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **tol)


def _port_grads(q, k, v, bias, w):
    tq, tk, tv, tb = (_t(x).requires_grad_() for x in (q, k, v, bias))
    out = flash_attention_with_bias(tq, tk, tv, tb)
    assert type(out.grad_fn).__name__ == "_AttentionCoreBackward"
    (out * _t(w)).sum().backward()
    return [x.grad.numpy() for x in (tq, tk, tv, tb)]


def _jax_grads(q, k, v, bias, w, block_q=None):
    def loss(q, k, v, bias):
        out = jfa.flash_attention_with_bias(q, k, v, bias=bias, block_q=block_q,
                                            interpret=True)
        return (out * jnp.asarray(w)).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("route,t", [("K4+K8", 77), ("K4+K8", 150), ("K4+K6/K7", 150),
                                     ("K2+K8", 77), ("K2+K8", 150)])
def test_function_grads_match_jax_custom_vjp(route, t, monkeypatch):
    q, k, v, bias, w = _inputs(2, t, seed=10 + t)
    block_q = None
    if route == "K4+K6/K7":
        block_q = 64
        tp = jfa._round_up(t, 128)
        assert jfa._split_bwd_block_q(64, 2 * H, tp, 128, 4) == 64 < tp
    if route.startswith("K2"):
        monkeypatch.setattr(jfa, "_DT_TRAIN_FWD", True)
    want = _jax_grads(q, k, v, bias, w, block_q)
    got = _port_grads(q, k, v, bias, w)
    for name, g, ref in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == ref.shape, name
        # fp32 throughout; the two sum the score-sized products in
        # different orders
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-5, err_msg=name)


def test_function_gradcheck_float64():
    # float64 so that every rounding step of the plain versions is exact to
    # gradcheck's finite differences; d = 16 keeps the Jacobian small
    q, k, v, bias, _ = _inputs(1, 9, seed=5, d=16)
    args = [torch.from_numpy(x.astype(np.float64)).requires_grad_() for x in (q, k, v, bias)]
    assert torch.autograd.gradcheck(flash_attention_with_bias, args, eps=1e-6, atol=1e-6)


def test_cpu_path_launches_no_kernel():
    counters = (flash_attention_with_bias, attention_fwd_lse, attention_bwd_dkdv,
                attention_bwd_dq_dbias)
    before = [c.launches for c in counters]
    q, k, v, bias, w = _inputs(1, 40, seed=6)
    _port_grads(q, k, v, bias, w)
    with torch.no_grad():
        flash_attention_with_bias(_t(q), _t(k), _t(v), _t(bias))
    assert [c.launches for c in counters] == before


def test_wrappers_on_cpu_take_the_plain_versions():
    q, k, v, bias, w = (_t(x) for x in _inputs(2, 33, seed=7))
    out, lse = attention_fwd_lse(q, k, v, bias)
    ref_out, ref_lse = attention_fwd_lse_plain(q, k, v, bias)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    dq, dk, dv, dbias = attention_bwd_plain(q, k, v, bias, out, lse, w)
    assert dbias.shape == (H, 33, 33) and dbias.dtype == torch.float32
    # the plain backward is the gradient of the plain forward: autograd
    # through attention_fwd_lse_plain gives the same four tensors
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    (attention_fwd_lse_plain(*leaves)[0] * w).sum().backward()
    for name, g, ref in zip(("dq", "dk", "dv", "dbias"), (dq, dk, dv, dbias), leaves):
        torch.testing.assert_close(g, ref.grad, rtol=1e-4, atol=1e-5, msg=name)


def test_forward_only_kernels_refuse_inputs_that_require_grad():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        build.refuse_grad("attention", x)
    with torch.no_grad():
        build.refuse_grad("attention", x)
    build.refuse_grad("sampler", torch.zeros(3), 1.0, None)


def test_function_grads_match_jax_custom_vjp_bf16_bias():
    # the serving LMs store the T5 table in bf16: q, k, v and the bias bf16,
    # as on the JAX route that keeps a bf16 bias in bf16 (K4 + K8)
    q, k, v, bias, w = _inputs(2, 77, seed=30)
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, bias)]

    def loss(q, k, v, bias):
        out = jfa.flash_attention_with_bias(q, k, v, bias=bias, interpret=True)
        return (out.astype(jnp.float32) * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*jx)
    leaves = [_t(np.asarray(x.astype(jnp.float32)), torch.bfloat16).requires_grad_()
              for x in jx]
    out = flash_attention_with_bias(*leaves)
    assert type(out.grad_fn).__name__ == "_AttentionCoreBackward"
    (out.float() * _t(w)).sum().backward()
    for name, g, ref in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        assert g.grad.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, name
        ref = np.asarray(ref.astype(jnp.float32))
        # the same roundings in the same places (P, dS, the outputs and
        # dbias's two bf16 casts); fp32 sums in other orders move a bf16
        # result by an ulp (2^-8 relative) here and there
        np.testing.assert_allclose(g.grad.float().numpy(), ref, rtol=2 ** -6,
                                   atol=2 ** -6 * float(np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("d", [32, 96])
def test_padded_head_dim_gives_the_unpadded_result(d):
    # the CUDA wrappers zero-pad d to 64 or 128 and keep the scale of d
    q, k, v, bias, w = (_t(x) for x in _inputs(2, 45, seed=d, d=d))
    dk = kernel_head_dim(d)
    assert dk == (64 if d <= 64 else 128)
    pq, pk, pv, pw = (pad_head(x, dk) for x in (q, k, v, w))
    scale = LOG2E / d ** 0.5
    out, lse = attention_fwd_lse_plain(q, k, v, bias)
    pout, plse = attention_fwd_lse_plain(pq, pk, pv, bias, q_scale=scale)
    delta = attention_delta(out, w)
    grads = attention_bwd_dkdv_plain(q, k, v, bias, lse, w, delta) + \
        attention_bwd_dq_dbias_plain(q, k, v, bias, lse, w, delta)
    pdelta = attention_delta(pout, pw)
    pgrads = attention_bwd_dkdv_plain(pq, pk, pv, bias, plse, pw, pdelta, q_scale=scale) + \
        attention_bwd_dq_dbias_plain(pq, pk, pv, bias, plse, pw, pdelta, q_scale=scale)
    assert not pout[..., d:].any() and torch.equal(pdelta, delta)
    # zero columns add exact zeros to every score and product: fp32
    # summation order only
    tol = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pout[..., :d], out, **tol)
    torch.testing.assert_close(plse, lse, **tol)
    for name, g, pg in zip(("dk", "dv", "dq", "dbias"), grads, pgrads):
        if name != "dbias":
            assert not pg[..., d:].any(), name
            pg = pg[..., :d]
        torch.testing.assert_close(pg, g, **tol, msg=name)


def test_head_dims_past_128_are_refused():
    assert kernel_head_dim(1) == 64 and kernel_head_dim(64) == 64
    assert kernel_head_dim(65) == 128 and kernel_head_dim(128) == 128
    with pytest.raises(ValueError, match="128"):
        kernel_head_dim(129)
