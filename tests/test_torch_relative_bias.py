"""The T5 bias's gradient with respect to its bucket table
(`vampnet_tpu_torch/ops/relative_bias.py`): `RelativePositionBias`, the
plain version of its backward, and the route `position_bias_from_table`
takes, against autograd's index backward through `table[buckets]` and
against `jax.grad` of the JAX package's `position_bias_from_params`.

Shapes: the coarse training step's (20 heads, t = 862), the c2f step's
(t = 259), and a rectangular bias (t_q != t_k). The bucket table and the
gradient come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (torch threads per xdist worker)
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules import transformer as jtr
from vampnet_tpu_torch.modules import LMConfig
from vampnet_tpu_torch.modules import transformer as ttr
from vampnet_tpu_torch.ops import relative_bias as rb

SHAPES = [pytest.param(20, 862, 862, id="coarse"), pytest.param(20, 259, 259, id="c2f"),
          pytest.param(20, 120, 301, id="rect")]
CFG = LMConfig()  # 32 buckets, max distance 128


def _inputs(h, t_q, t_k, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((CFG.attention_num_buckets, h)).astype(np.float32)
    dbias = rng.standard_normal((h, t_q, t_k)).astype(np.float32)
    return table, dbias


def _buckets(t_q, t_k):
    rel = torch.arange(t_k)[None, :] - torch.arange(t_q)[:, None]
    return ttr.relative_position_bucket(rel, True, CFG.attention_num_buckets,
                                        CFG.attention_max_distance)


def _todays_bias(table, t_q, t_k):
    """What `position_bias_from_table` returned before the Function."""
    return table[_buckets(t_q, t_k)].permute(2, 0, 1).contiguous()


def _offsets(t_q, t_k):
    return ttr.relative_position_bucket(torch.arange(-(t_q - 1), t_k), True,
                                        CFG.attention_num_buckets, CFG.attention_max_distance)


def _assert_reorder_close(got, want, dbias, t_q, t_k):
    """fp32 sums of the same terms in another order: each bucket's sum may
    move by a small multiple of eps = 2^-23 times the sum of its terms'
    magnitudes (sequential and tree sums of up to 300,000 terms read
    1e-7 of it here), so hold it to 1e-6 of that sum."""
    mag = torch.zeros(CFG.attention_num_buckets, dbias.shape[0], dtype=torch.float64)
    terms = torch.from_numpy(np.abs(dbias)).double().permute(1, 2, 0)
    mag.index_put_((_buckets(t_q, t_k).reshape(-1),), terms.reshape(-1, dbias.shape[0]),
                   accumulate=True)
    mag = mag.numpy()
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 * mag).all(), float((err / np.maximum(mag, 1e-30)).max())


@pytest.mark.parametrize("h,t_q,t_k", SHAPES)
def test_plain_backward_matches_autograd_index_backward(h, t_q, t_k):
    table, dbias = _inputs(h, t_q, t_k)
    tab = torch.from_numpy(table).requires_grad_()
    (want,) = torch.autograd.grad(_todays_bias(tab, t_q, t_k), tab, torch.from_numpy(dbias))
    got = rb.relative_bias_grad(torch.from_numpy(dbias), _offsets(t_q, t_k),
                                CFG.attention_num_buckets)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_reorder_close(got, want, dbias, t_q, t_k)


@pytest.mark.parametrize("h,t_q,t_k", SHAPES)
def test_table_gradient_matches_jax_grad(h, t_q, t_k):
    table, dbias = _inputs(h, t_q, t_k, seed=1)
    jcfg = JLMConfig(n_heads=h)
    params = {"transformer": {"layers_0": {"self_attn": {
        "relative_attention_bias": jnp.asarray(table)}}}}
    _, vjp = jax.vjp(lambda p: jtr.position_bias_from_params(p, jcfg, t_q, t_k), params)
    (jgrad,) = vjp(jnp.asarray(dbias))
    want = np.asarray(jgrad["transformer"]["layers_0"]["self_attn"]["relative_attention_bias"])
    tab = torch.from_numpy(table).requires_grad_()
    bias = ttr.position_bias_from_table(tab, LMConfig(n_heads=h), t_q, t_k)
    assert isinstance(bias.grad_fn, rb.RelativePositionBias._backward_cls)
    (got,) = torch.autograd.grad(bias, tab, torch.from_numpy(dbias))
    _assert_reorder_close(got, want, dbias, t_q, t_k)


@pytest.mark.parametrize("h,t_q,t_k", SHAPES)
def test_forward_is_todays_bit_for_bit(h, t_q, t_k):
    table, _ = _inputs(h, t_q, t_k, seed=2)
    want = _todays_bias(torch.from_numpy(table), t_q, t_k)
    # the per-offset vector indexes the same buckets as the 2-D bucket function
    assert torch.equal(rb.bucket_index(_offsets(t_q, t_k), t_q, t_k), _buckets(t_q, t_k))
    tab = torch.from_numpy(table).requires_grad_()
    with_grad = ttr.position_bias_from_table(tab, CFG, t_q, t_k)
    with torch.no_grad():
        without = ttr.position_bias_from_table(tab, CFG, t_q, t_k)
    frozen = ttr.position_bias_from_table(torch.from_numpy(table), CFG, t_q, t_k)
    for got in (with_grad, without, frozen):
        assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("h,t_q,t_k", SHAPES)
def test_function_entered_only_when_the_table_takes_a_gradient(h, t_q, t_k, monkeypatch):
    """Every bias goes through `RelativePositionBias`, but only a table that
    takes a gradient (grad mode on, the table trainable) records its node
    and so reaches its backward: under no_grad, under inference_mode and for
    a frozen table the bias has no graph and the backward is never called."""
    grads = []
    grad = rb.relative_bias_grad
    monkeypatch.setattr(rb, "relative_bias_grad", lambda *a: grads.append(1) or grad(*a))
    table, dbias = _inputs(h, t_q, t_k, seed=3)
    tab = torch.from_numpy(table).requires_grad_()
    with torch.no_grad():
        no_grad = ttr.position_bias_from_table(tab, CFG, t_q, t_k)
    with torch.inference_mode():
        inference = ttr.position_bias_from_table(tab, CFG, t_q, t_k)
    frozen = ttr.position_bias_from_table(torch.from_numpy(table), CFG, t_q, t_k)
    for bias in (no_grad, inference, frozen):
        assert bias.grad_fn is None and not bias.requires_grad
    bias = ttr.position_bias_from_table(tab, CFG, t_q, t_k)
    assert isinstance(bias.grad_fn, rb.RelativePositionBias._backward_cls)
    assert grads == []
    bias.backward(torch.from_numpy(dbias))
    assert grads == [1] and tab.grad.shape == tab.shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_backward_takes_a_bf16_gradient_and_returns_the_tables_dtype(dtype):
    h, t_q, t_k = 4, 70, 90
    table, dbias = _inputs(h, t_q, t_k, seed=4)
    g16 = torch.from_numpy(dbias).to(torch.bfloat16)
    got = rb.relative_bias_grad(g16, _offsets(t_q, t_k), CFG.attention_num_buckets, dtype)
    want = rb.relative_bias_grad(g16.float(), _offsets(t_q, t_k), CFG.attention_num_buckets)
    assert got.dtype == dtype
    # the bf16 gradient is widened exactly, summed in fp32, then rounded once
    assert torch.equal(got, want.to(dtype))
    tab = torch.from_numpy(table).to(dtype).requires_grad_()
    (gt,) = torch.autograd.grad(ttr.position_bias_from_table(tab, CFG, t_q, t_k), tab,
                                g16.to(dtype))
    assert gt.dtype == dtype


def test_relative_bias_grad_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="offset_buckets"):
        rb.relative_bias_grad(torch.zeros(2, 5, 7), torch.zeros(10, dtype=torch.long), 32)
