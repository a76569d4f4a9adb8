"""Port parity: the masked and long-context attention. The plain versions of
the masked forward (K3), the masked backward (K5) and the long forward (K9)
that the wrappers take on CPU tensors, against the JAX package's Pallas
kernels (interpret mode), its custom VJP with a mask, and its XLA path.

Every kernel-parity mask leaves each query row at least one open key. A row
with none is pinned separately to the XLA route, which the port follows
there (the JAX Pallas path averages over its padded keys instead).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from vampnet_tpu.ops.attention import dot_product_attention as j_dpa
from vampnet_tpu.ops.flash_attention import flash_attention_with_bias as j_flash
from vampnet_tpu_torch.ops import attention as tatt
from vampnet_tpu_torch.ops import flash_attention as fa
from vampnet_tpu_torch.ops.attention import dot_product_attention
from vampnet_tpu_torch.ops.flash_attention import (
    attention_bwd_plain,
    attention_fwd_lse_plain,
    attention_fwd_plain,
    attention_mask,
    flash_attention_with_bias,
)


def _inputs(b, t, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((h, t, t)).astype(np.float32)
    w = rng.standard_normal((b, t, h, d)).astype(np.float32)  # d loss / d out
    return q, k, v, bias, w


def _mask(b, t, kind, seed=0):
    """(b, t, t) int32, 0 = blocked, every query row with an open key."""
    rng = np.random.default_rng(seed)
    if kind == "key_padding":  # rows of t, 3t/4, t/2, ... valid keys
        valid = [max(1, t - i * t // 4) for i in range(b)]
        m = (np.arange(t)[None, None, :] < np.array(valid)[:, None, None])
        m = np.broadcast_to(m, (b, t, t))
    else:  # random, a third blocked, the diagonal open
        m = rng.random((b, t, t)) > 1 / 3
        m[:, np.arange(t), np.arange(t)] = True
    return np.ascontiguousarray(m).astype(np.int32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("kind", ["key_padding", "random"])
@pytest.mark.parametrize("t", [64, 100])
def test_masked_forward_matches_pallas_k3_and_xla(t, kind):
    q, k, v, bias, _ = _inputs(2, t, seed=t)
    mask = _mask(2, t, kind, seed=t)
    jq, jk, jv, jb, jm = _j(q, k, v, bias, mask)
    want_pallas = np.asarray(j_flash(jq, jk, jv, bias=jb, mask=jm, interpret=True))
    want_xla = np.asarray(j_dpa(jq, jk, jv, bias=jb, mask=jm, impl="xla"))
    args = (_t(q), _t(k), _t(v), _t(bias))
    got_kernel = flash_attention_with_bias(*args, mask=_t(mask, torch.int32)).numpy()
    got_auto = dot_product_attention(*args, mask=_t(mask, torch.int32)).numpy()
    # fp32 softmax attention: the base-2 and natural-log forms and the
    # summation orders differ by float rounding only
    tol = dict(atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(got_kernel, want_pallas, **tol)
    np.testing.assert_allclose(got_kernel, want_xla, **tol)
    np.testing.assert_allclose(got_auto, want_xla, **tol)


@pytest.mark.parametrize("kind,t", [("key_padding", 77), ("random", 77), ("random", 150)])
def test_masked_function_grads_match_jax_custom_vjp_k5(kind, t):
    q, k, v, bias, w = _inputs(2, t, seed=40 + t)
    mask = _mask(2, t, kind, seed=t)

    def loss(q, k, v, bias):
        out = j_flash(q, k, v, bias=bias, mask=jnp.asarray(mask), interpret=True)
        return (out * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*_j(q, k, v, bias))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    out = flash_attention_with_bias(*leaves, mask=_t(mask, torch.bool))
    assert type(out.grad_fn).__name__ == "_AttentionCoreBackward"
    (out * _t(w)).sum().backward()
    for name, leaf, ref in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        # fp32 throughout (the limits of the unmasked VJP test); the two sum
        # the score-sized products in different orders
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_masked_function_gradcheck_float64():
    # a key-padding row, a random row and a row with no open key (whose
    # output does not move with q, k or the bias)
    q, k, v, bias, _ = _inputs(2, 9, seed=5, d=16)
    mask = _mask(2, 9, "random", seed=3).astype(bool)
    mask[0, 4] = False
    mask[1, :, 6:] = False
    tmask = torch.from_numpy(mask)
    args = [torch.from_numpy(x.astype(np.float64)).requires_grad_() for x in (q, k, v, bias)]
    fn = lambda q, k, v, bias: flash_attention_with_bias(q, k, v, bias, mask=tmask)  # noqa: E731
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


def test_masked_plain_backward_is_the_gradient_of_the_plain_forward():
    q, k, v, bias, w = (_t(x) for x in _inputs(2, 33, seed=7))
    mask = torch.from_numpy(_mask(2, 33, "random", seed=8).astype(bool))
    mask[1, 5] = False  # a row with no open key
    out, lse = attention_fwd_lse_plain(q, k, v, bias, mask=mask)
    grads = attention_bwd_plain(q, k, v, bias, out, lse, w, mask=mask)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    (attention_fwd_lse_plain(*leaves, mask=mask)[0] * w).sum().backward()
    for name, g, ref in zip(("dq", "dk", "dv", "dbias"), grads, leaves):
        torch.testing.assert_close(g, ref.grad, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("t", [1500, 2048])
def test_long_forward_matches_pallas_blocked_k9(t):
    # b=1 and h=2 keep the JAX interpreter quick at these lengths
    q, k, v, bias, _ = _inputs(1, t, seed=t)
    want = np.asarray(j_flash(*_j(q, k, v), bias=jnp.asarray(bias), interpret=True))
    got = flash_attention_with_bias(_t(q), _t(k), _t(v), _t(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-4)


def test_long_masked_forward_matches_pallas_blocked_k9():
    t = 1200
    q, k, v, bias, _ = _inputs(1, t, seed=12)
    mask = np.ones((1, t, t), np.int32)
    mask[:, :, 900:] = 0
    want = np.asarray(j_flash(*_j(q, k, v), bias=jnp.asarray(bias), mask=jnp.asarray(mask),
                              interpret=True))
    got = flash_attention_with_bias(_t(q), _t(k), _t(v), _t(bias), mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-4)


def test_routes(monkeypatch):
    """flash_attention_with_bias routes as the JAX wrapper does: K9 past
    1024, K3 with a mask, K1 without, the Function when grad is needed."""
    calls = []
    for name in ("attention_fwd", "attention_fwd_masked", "attention_fwd_long"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    for t, with_mask in ((40, False), (40, True), (1030, False), (1030, True)):
        q, k, v, bias, _ = (_t(x) for x in _inputs(1, t, h=1, d=8, seed=t))
        mask = torch.ones((1, t, t), dtype=torch.bool) if with_mask else None
        flash_attention_with_bias(q, k, v, bias, mask)
    assert calls == ["attention_fwd", "attention_fwd_masked", "attention_fwd_long",
                     "attention_fwd_long"]
    q, k, v, bias, _ = (_t(x).requires_grad_() for x in _inputs(1, 1030, h=1, d=8, seed=1))
    out = flash_attention_with_bias(q, k, v, bias)
    assert type(out.grad_fn).__name__ == "_AttentionCoreBackward"
    assert len(calls) == 4


def _fully_blocked_case():
    b, t = 2, 40
    q, k, v, bias, w = _inputs(b, t, seed=21)
    mask = _mask(b, t, "random", seed=22)
    mask[0, 7] = 0  # query row 7 of batch row 0 sees no key
    mask[1, 30:] = 0  # the last ten query rows of batch row 1 see none
    return q, k, v, bias, w, mask


def test_fully_blocked_row_follows_xla():
    q, k, v, bias, w, mask = _fully_blocked_case()
    t = q.shape[1]
    jq, jk, jv, jb, jm = _j(q, k, v, bias, mask)
    want_xla = np.asarray(j_dpa(jq, jk, jv, bias=jb, mask=jm, impl="xla"))
    args = (_t(q), _t(k), _t(v), _t(bias))
    got = flash_attention_with_bias(*args, mask=_t(mask)).numpy()
    lib = dot_product_attention(*args, mask=_t(mask), impl="xla").numpy()
    # such a row averages v over the t keys
    np.testing.assert_allclose(got[0, 7], v[0].mean(axis=0), atol=1e-6, rtol=1e-5)
    for out in (got, lib):
        np.testing.assert_allclose(out, want_xla, atol=2e-5, rtol=2e-4)
    # the known difference: the JAX Pallas path pads t = 40 keys to 128 with
    # -1e9, as the mask fills, so it averages over 128 (zero-padded) keys
    want_pallas = np.asarray(j_flash(jq, jk, jv, bias=jb, mask=jm, interpret=True))
    np.testing.assert_allclose(want_pallas[0, 7], v[0].sum(axis=0) / 128, atol=1e-5)
    np.testing.assert_allclose(np.delete(got[0], 7, axis=0), np.delete(want_pallas[0], 7, axis=0),
                               atol=2e-5, rtol=2e-4)
    assert t < 128


def test_fully_blocked_row_gradients_follow_xla():
    q, k, v, bias, w, mask = _fully_blocked_case()

    def loss(q, k, v, bias):
        out = j_dpa(q, k, v, bias=bias, mask=jnp.asarray(mask), impl="xla")
        return (out * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*_j(q, k, v, bias))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    (flash_attention_with_bias(*leaves, mask=_t(mask)) * _t(w)).sum().backward()
    for name, leaf, ref in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # nothing reaches q through a row with no open key
    assert not leaves[0].grad[0, 7].any() and not leaves[0].grad[1, 30:].any()


def test_impl_xla_is_the_library_call_and_matches_jax_xla():
    q, k, v, bias, _ = _inputs(2, 50, seed=31)
    mask = _mask(2, 50, "key_padding")
    args = (_t(q), _t(k), _t(v), _t(bias))
    for m in (None, mask, mask[:, None]):
        want = np.asarray(j_dpa(*_j(q, k, v, bias), mask=None if m is None else jnp.asarray(m),
                                impl="xla"))
        got = dot_product_attention(*args, mask=None if m is None else _t(m), impl="xla")
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)
    calls = []
    real = torch.nn.functional.scaled_dot_product_attention
    orig = tatt.F.scaled_dot_product_attention
    try:
        tatt.F.scaled_dot_product_attention = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        dot_product_attention(*args, impl="xla")
    finally:
        tatt.F.scaled_dot_product_attention = orig
    assert calls == [1]


def test_impl_ring_and_unknown_impls_are_refused():
    q, k, v, bias, _ = (_t(x) for x in _inputs(1, 8, seed=2))
    # ring attention needs every shard of the sequence: it runs in a
    # RingStack (tests/test_torch_ring_attention.py), never through here
    with pytest.raises(RuntimeError, match="ring context"):
        dot_product_attention(q, k, v, bias, impl="ring")
    with pytest.raises(ValueError, match="impl"):
        dot_product_attention(q, k, v, bias, impl="flash")
    # "pallas" on CPU tensors is the kernels' plain version
    assert torch.equal(dot_product_attention(q, k, v, bias, impl="pallas"),
                       attention_fwd_plain(q, k, v, bias))


def test_masks_of_another_shape_or_device_are_refused():
    q, k, v, bias, _ = (_t(x) for x in _inputs(2, 8, seed=3))
    with pytest.raises(ValueError, match="mask must be"):
        flash_attention_with_bias(q, k, v, bias, mask=torch.ones((2, 8, 9)))
    with pytest.raises(ValueError, match="mask must be"):
        flash_attention_with_bias(q, k, v, bias, mask=torch.ones((1, 8, 8)))
    with pytest.raises(ValueError, match="lies on"):
        flash_attention_with_bias(q, k, v, bias, mask=torch.ones((2, 8, 8), device="meta"))
    m4 = torch.ones((2, 1, 8, 8), dtype=torch.int32)
    m = attention_mask(m4, q)
    assert m.dtype == torch.bool and tuple(m.shape) == (2, 8, 8) and m.is_contiguous()
    assert torch.equal(flash_attention_with_bias(q, k, v, bias, mask=m4),
                       flash_attention_with_bias(q, k, v, bias, mask=m))


def test_cpu_masked_path_launches_no_kernel():
    counters = (fa.flash_attention_with_bias, fa.attention_fwd_masked, fa.attention_fwd_long,
                fa.attention_fwd_lse_masked, fa.attention_bwd_fused_masked)
    before = [c.launches for c in counters]
    q, k, v, bias, w = _inputs(1, 30, seed=9)
    mask = _t(_mask(1, 30, "random"))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    (flash_attention_with_bias(*leaves, mask=mask) * _t(w)).sum().backward()
    with torch.no_grad():
        flash_attention_with_bias(*(x.detach() for x in leaves), mask=mask)
    assert [c.launches for c in counters] == before
