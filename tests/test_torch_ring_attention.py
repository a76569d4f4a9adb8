"""Port parity: ring attention (`ops/ring_attention.py`) and the LM's
`attention_impl="ring"` route (`RingStack`), over a repeated-device sp mesh
(`["cpu"] * 8`), against the JAX package's `ring_attention` under
`shard_map` on its 8 virtual CPU devices and against whole-sequence
attention.

The bounds are the JAX tests' own (`tests/test_ring_attention.py`): atol
2e-3 and rtol 1e-2 for the attention, and atol 6e-2, rtol 5e-2 with a
correlation above 0.9999 for the bf16 LM's logits.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from test_torch_util import lm_params_np, to_jax
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.modules.transformer import relative_position_bucket as jbucket
from vampnet_tpu.ops.ring_attention import ring_attention as jring_attention
from vampnet_tpu_torch.convert import lm_state_dict_from_jax
from vampnet_tpu_torch.modules import LMConfig, VampNetLM
from vampnet_tpu_torch.modules.transformer import RingStack, position_bias_from_params
from vampnet_tpu_torch.ops import ring_attention as ring_mod
from vampnet_tpu_torch.ops.attention import attention_plain, dot_product_attention
from vampnet_tpu_torch.ops.flash_attention import FULLY_BLOCKED_LSE
from vampnet_tpu_torch.ops.ring_attention import ring_attention
from vampnet_tpu_torch.parallel import make_sp_mesh
from vampnet_tpu_torch.parallel.placement import Placement

N = 8
ATOL, RTOL = 2e-3, 1e-2


_JAX_RINGS = {}


def _jax_ring(q, k, v, table):
    """JAX's ring attention under shard_map over the 8 virtual devices, one
    compiled program per shape: without a bias it is given a zero table,
    whose bias blocks are the zeros JAX's ring builds for no table."""
    if table is None:
        table = np.zeros((32, q.shape[2]), np.float32)
    key = (q.shape, table.shape)
    if key not in _JAX_RINGS:
        fn = lambda q, k, v, tbl: jring_attention(q, k, v, tbl, "sp", bucket_fn=jbucket)  # noqa: E731
        _JAX_RINGS[key] = jax.jit(jax.shard_map(
            fn, mesh=Mesh(np.array(jax.devices()[:N]), ("sp",)),
            in_specs=(JP(None, "sp"),) * 3 + (JP(),), out_specs=JP(None, "sp")))
    return np.asarray(_JAX_RINGS[key](*map(jnp.asarray, (q, k, v, table))))


def _blocks(table, tl, num_buckets=32, max_distance=128):
    """bias_block(i, src): the (h, tl, tl) bias of query shard i against key
    shard src from the bucket table, as `RingStack.bias_block` builds it."""
    from vampnet_tpu_torch.modules.transformer import relative_position_bucket

    def block(i, src):
        pos = torch.arange(tl)
        rel = (src - i) * tl + pos[None, :] - pos[:, None]
        buckets = relative_position_bucket(rel, True, num_buckets, max_distance)
        return table[buckets].permute(2, 0, 1)

    return block


def _full_bias(table, t):
    from vampnet_tpu_torch.modules.transformer import relative_position_bucket

    rel = torch.arange(t)[None, :] - torch.arange(t)[:, None]
    return table[relative_position_bucket(rel, True, 32, 128)].permute(2, 0, 1)


def _split(x):
    return [c.contiguous() for c in torch.from_numpy(x).chunk(N, dim=1)]


@pytest.mark.parametrize("t", [1024, 4096])
@pytest.mark.parametrize("with_bias", [True, False])
def test_ring_attention_matches_jax_ring_and_full_attention(t, with_bias):
    """Against JAX's ring under shard_map (one compile per t, shared by
    the cases with and without a bias), and without a bias also against
    JAX's whole-sequence XLA attention, which the JAX test holds its ring
    to."""
    from vampnet_tpu.ops.attention import dot_product_attention as jdot_product_attention

    b, h, d = 1, 4, 64
    rng = np.random.default_rng(t + with_bias)
    q = (0.5 * rng.standard_normal((b, t, h, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((b, t, h, d))).astype(np.float32)
    v = rng.standard_normal((b, t, h, d)).astype(np.float32)
    table = rng.standard_normal((32, h)).astype(np.float32) if with_bias else None

    tl = t // N
    block = _blocks(torch.from_numpy(table), tl) if with_bias else None
    outs = ring_attention(_split(q), _split(k), _split(v), block)
    assert len(outs) == N and all(o.shape == (b, tl, h, d) for o in outs)
    got = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(got, _jax_ring(q, k, v, table), atol=ATOL, rtol=RTOL)
    if not with_bias:
        want = jdot_product_attention(*map(jnp.asarray, (q, k, v)), bias=None, impl="xla")
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    # and the port's whole-sequence attention (the (t, t) bias built)
    bias = _full_bias(torch.from_numpy(table), t) if with_bias else None
    full = attention_plain(*map(torch.from_numpy, (q, k, v)), bias)
    np.testing.assert_allclose(got, full.numpy(), atol=ATOL, rtol=RTOL)


def test_ring_attention_no_bias_batched_narrow_heads():
    b, t, h, d = 2, 512, 2, 32
    rng = np.random.default_rng(7)
    q, k = ((0.3 * rng.standard_normal((b, t, h, d))).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, t, h, d)).astype(np.float32)
    got = torch.cat(ring_attention(_split(q), _split(k), _split(v)), dim=1).numpy()
    np.testing.assert_allclose(got, _jax_ring(q, k, v, None), atol=ATOL, rtol=RTOL)


def test_ring_attention_routes_cpu_shards_to_the_plain_version(monkeypatch):
    """CPU shards never reach the kernel route (whose per-block lse merge
    is the CUDA path); its merge is held in the next test."""
    monkeypatch.setattr(ring_mod, "ring_attention_kernel",
                        lambda *a: (_ for _ in ()).throw(AssertionError("kernel route")))
    x = [torch.randn(1, 8, 2, 16) for _ in range(4)]
    assert len(ring_attention(x, x, x)) == 4
    with pytest.raises(ValueError, match="equal shards"):
        ring_attention(x, x, x[:3] + [torch.randn(1, 9, 2, 16)])


def test_lse_merge_equals_attention_and_tolerates_sentinels():
    """The kernel route's merge of per-block (out, lse) pairs, run here on
    the blocks' plain outputs: the merged rows equal attention over all the
    keys; an lse of -inf or the kernel's fully-blocked sentinel weighs 0
    beside a finite one and never makes a NaN."""
    from vampnet_tpu_torch.ops.flash_attention import attention_fwd_lse_plain

    rng = np.random.default_rng(3)
    b, tl, h, d, n = 2, 16, 3, 32, 4
    q = torch.from_numpy(rng.standard_normal((b, tl, h, d)).astype(np.float32))
    ks = [torch.from_numpy(rng.standard_normal((b, tl, h, d)).astype(np.float32))
          for _ in range(n)]
    vs = [torch.from_numpy(rng.standard_normal((b, tl, h, d)).astype(np.float32))
          for _ in range(n)]
    state = None
    for k, v in zip(ks, vs):
        state = ring_mod._merge(state, *attention_fwd_lse_plain(q, k, v))
    whole, lse_whole = attention_fwd_lse_plain(q, torch.cat(ks, 1), torch.cat(vs, 1))
    # attention over n*tl keys: the plain kernel wants square shapes, so
    # hold against the reference softmax directly
    s = torch.einsum("bqhd,bkhd->bhqk", q, torch.cat(ks, 1)) / math.sqrt(d)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), torch.cat(vs, 1))
    np.testing.assert_allclose(state[0].numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    del whole, lse_whole

    out = torch.from_numpy(rng.standard_normal((1, 4, 1, 2)).astype(np.float32))
    good = torch.zeros(1, 4)
    for bad in (-math.inf, FULLY_BLOCKED_LSE, 2 * FULLY_BLOCKED_LSE):
        acc, lse = ring_mod._merge(ring_mod._merge(None, out * 0 + 7.0,
                                                   torch.full((1, 4), bad)), out, good)
        assert torch.isfinite(acc).all() and torch.isfinite(lse).all()
        np.testing.assert_allclose(acc.numpy(), out.numpy(), atol=1e-6)
    acc, lse = ring_mod._merge(ring_mod._merge(None, out, torch.full((1, 4), -math.inf)),
                               out, torch.full((1, 4), -math.inf))
    assert not torch.isnan(acc).any() and torch.isneginf(lse).all()
    # two sentinels alone average, as a row with no open key does
    acc, _ = ring_mod._merge(ring_mod._merge(None, out, torch.full((1, 4), FULLY_BLOCKED_LSE)),
                             3 * out, torch.full((1, 4), FULLY_BLOCKED_LSE))
    np.testing.assert_allclose(acc.numpy(), 2 * out.numpy(), rtol=1e-6)


def test_impl_ring_outside_a_ring_context_raises():
    x = torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="ring context"):
        dot_product_attention(x, x, x, impl="ring")


def _ring_lm_pair(t=256, compute_dtype="bfloat16"):
    jcfg = JLMConfig(n_heads=2, n_layers=2, n_codebooks=2, latent_dim=4, embedding_dim=32,
                     vocab_size=32, dropout=0.0, attention_impl="xla",
                     compute_dtype=compute_dtype)
    tcfg = LMConfig(n_heads=2, n_layers=2, n_codebooks=2, latent_dim=4, embedding_dim=32,
                    vocab_size=32, compute_dtype=compute_dtype)
    params = lm_params_np(jcfg, 5)
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 32, (1, 2, t))
    cbs = rng.standard_normal((2, 32, 4)).astype(np.float32)
    return jcfg, tcfg, params, codes, cbs


def _port_lm(tcfg, params):
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_jax(params, tcfg), strict=True)
    return lm.requires_grad_(False)


def test_lm_forward_with_ring_attention_matches_jax():
    """The LM with attention_impl="ring" through an sp placement over 8
    repeated CPU devices, against JAX's ring LM under shard_map on its 8
    virtual devices, the JAX LM's whole-sequence XLA forward and the port's
    unsharded forward (bf16 compute, the JAX test's bound)."""
    jcfg, tcfg, params, codes, cbs = _ring_lm_pair()
    jparams = to_jax(params)
    ref = np.asarray(JVampNetLM(jcfg).apply({"params": jparams}, jnp.asarray(codes),
                                             jnp.asarray(cbs), method="forward_codes"))
    ring_model = JVampNetLM(dataclasses.replace(jcfg, attention_impl="ring"))
    jring = np.asarray(jax.jit(jax.shard_map(
        lambda p, c, cb: ring_model.apply({"params": p}, c, cb, method="forward_codes"),
        mesh=Mesh(np.array(jax.devices()[:N]), ("sp",)),
        in_specs=(JP(), JP(None, None, "sp"), JP()), out_specs=JP(None, "sp"),
    ))(jparams, jnp.asarray(codes), jnp.asarray(cbs)))

    ring_lm = _port_lm(dataclasses.replace(tcfg, attention_impl="ring"), params)
    with pytest.raises(RuntimeError, match="ring context"):
        ring_lm.forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs))
    place = Placement(ring_lm, make_sp_mesh(devices=["cpu"] * N))
    with torch.inference_mode():
        got = place.forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs)).numpy()
        plain = _port_lm(tcfg, params).forward_codes(torch.from_numpy(codes),
                                                     torch.from_numpy(cbs)).numpy()
    assert got.shape == ref.shape == jring.shape
    for want in (ref, jring, plain):
        np.testing.assert_allclose(got, want, atol=6e-2, rtol=5e-2)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_ring_bias_blocks_are_blocks_of_the_whole_bias():
    """RingStack builds each (query shard, key shard) bias block from the
    bucket table; together they are the (t, t) bias, which it never builds."""
    _, tcfg, params, _, _ = _ring_lm_pair(compute_dtype="float32")
    lm = _port_lm(tcfg, params)
    t, n = 512, 4
    stack = RingStack(lm, ["cpu"] * n)
    full = position_bias_from_params(lm, t)
    tl = t // n
    for i in range(n):
        for src in range(n):
            torch.testing.assert_close(stack.bias_block(i, src, tl),
                                       full[:, i * tl:(i + 1) * tl, src * tl:(src + 1) * tl],
                                       rtol=0, atol=0)
    assert len(stack._blocks) == 2 * n - 1  # one per offset
    with pytest.raises(ValueError, match="equal shards"):
        stack(torch.zeros(1, t + 1, tcfg.embedding_dim))
