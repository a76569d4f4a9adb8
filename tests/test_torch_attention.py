"""Port parity: attention. The plain dispatcher path against the JAX XLA
path, and the attention kernel's plain version against the Pallas kernel it
replaces (`_attn_kernel_dt`, run in interpret mode), at a t that is not a
multiple of 128 so the key padding is exercised."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampnet_tpu.ops.attention import dot_product_attention as j_dpa
from vampnet_tpu.ops.flash_attention import flash_attention_with_bias as j_flash
from vampnet_tpu_torch.ops.attention import attention_plain, dot_product_attention
from vampnet_tpu_torch.ops.flash_attention import (
    attention_fwd_plain,
    flash_attention_with_bias,
)


def _inputs(b=2, t=150, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((h, t, t)).astype(np.float32)
    return q, k, v, bias


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_attention_matches_jax_xla_and_pallas_fp32(with_bias):
    q, k, v, bias = _inputs()
    bias = bias if with_bias else None
    got = attention_plain(_t(q), _t(k), _t(v), None if bias is None else _t(bias)).numpy()
    jb = None if bias is None else jnp.asarray(bias)
    want_xla = np.asarray(j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb))
    want_pallas = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb,
                                     interpret=True))
    # fp32 softmax attention over 150 keys: summation order only
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


def test_kernel_plain_version_matches_pallas_fp32():
    q, k, v, bias = _inputs(t=77, seed=1)
    got = attention_fwd_plain(_t(q), _t(k), _t(v), _t(bias)).numpy()
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              bias=jnp.asarray(bias), interpret=True))
    # same base-2 formulation step for step; fp32 summation order only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
def test_kernel_plain_version_matches_pallas_bf16(bias_dtype):
    q, k, v, bias = _inputs(t=130, seed=2)
    jdt = jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    jbias = jnp.asarray(bias).astype(getattr(jnp, bias_dtype))
    want = np.asarray(j_flash(jq, jk, jv, bias=jbias, interpret=True).astype(jnp.float32))
    tq, tk, tv = (_t(np.asarray(x.astype(jnp.float32)), torch.bfloat16) for x in (jq, jk, jv))
    tbias = _t(np.asarray(jbias.astype(jnp.float32)), getattr(torch, bias_dtype))
    got = attention_fwd_plain(tq, tk, tv, tbias).float().numpy()
    # the same roundings (q prefold, bias prefold, P to bf16, output to bf16)
    # in the same places; the fp32 sums differ in order, which can move an
    # output by one bf16 ulp (2^-8 relative) where it sits on a boundary
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_dispatch_on_cpu_takes_the_plain_paths():
    q, k, v, bias = _inputs(t=40, seed=3)
    args = (_t(q), _t(k), _t(v), _t(bias))
    assert torch.equal(dot_product_attention(*args), attention_plain(*args))
    assert torch.equal(flash_attention_with_bias(*args), attention_fwd_plain(*args))
    assert flash_attention_with_bias.launches == 0
