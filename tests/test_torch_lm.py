"""Port parity: the LM (`modules/transformer.py`, `layers.py`, `lora.py`) and
the weight bridge (`convert.py`), against the JAX modules on one numpy param
tree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import configs, lm_params_np, to_jax
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.modules import transformer as jtr
from vampnet_tpu_torch.convert import lm_state_dict_from_jax
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.modules import transformer as ttr
from vampnet_tpu_torch.modules.lora import LoRADense


def _port_lm(tcfg, params_np):
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_jax(params_np, tcfg), strict=True)
    return lm.requires_grad_(False)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64), (32, 32)])
def test_relative_position_buckets_exact(num_buckets, max_distance):
    rel = np.arange(-1100, 1101)
    want = np.asarray(jtr.relative_position_bucket(
        jnp.asarray(rel), True, num_buckets, max_distance))
    got = ttr.relative_position_bucket(torch.from_numpy(rel), True, num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["coarse", "c2f"])
def test_state_dict_covers_every_param(name):
    _, _, lms = configs()
    jcfg, tcfg = lms[name]
    sd = lm_state_dict_from_jax(lm_params_np(jcfg, 0), tcfg)
    model_sd = VampNetLM(tcfg, device="meta").state_dict()
    assert set(sd) == set(model_sd)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(model_sd[k].shape), k


@pytest.mark.parametrize("name,t", [("coarse", 37), ("c2f", 25)])
def test_forward_codes_logits_match_jax_fp32(name, t):
    _, _, lms = configs("float32")
    jcfg, tcfg = lms[name]
    params = lm_params_np(jcfg, 1)
    rng = np.random.default_rng(2)
    codes = rng.integers(0, jcfg.vocab_size + 1, (2, jcfg.n_codebooks, t))  # incl. MASK
    cbs = rng.standard_normal((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim)).astype(np.float32)

    want = np.asarray(JVampNetLM(jcfg).apply(
        {"params": to_jax(params)}, jnp.asarray(codes), jnp.asarray(cbs), method="forward_codes"))
    got = _port_lm(tcfg, params).forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # fp32 end to end through 2 layers: the two frameworks sum matmuls in
    # different orders, ~1e-6 relative per op
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_position_bias_matches_jax():
    _, _, lms = configs()
    jcfg, tcfg = lms["coarse"]
    params = lm_params_np(jcfg, 3)
    want = np.asarray(jtr.position_bias_from_params(to_jax(params), jcfg, 41))
    got = ttr.position_bias_from_params(_port_lm(tcfg, params), 41)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_codes_bf16_close_to_fp32():
    _, _, lms32 = configs("float32")
    _, _, lms16 = configs("bfloat16")
    params = lm_params_np(lms32["coarse"][0], 4)
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 64, (1, 2, 19)))
    cbs = torch.from_numpy(rng.standard_normal((2, 64, 4)).astype(np.float32))
    ref = _port_lm(lms32["coarse"][1], params).forward_codes(codes, cbs)
    got = _port_lm(lms16["coarse"][1], params).forward_codes(codes, cbs)
    # bf16 keeps ~3 significant digits; logits here are O(1)-O(10)
    err = (got - ref).abs().max() / ref.abs().max()
    assert float(err) < 0.05


def test_lora_rank_above_zero_is_not_ported():
    # ported since: rank 8 adds the flax-shaped adapters, a no-op when fresh
    dense = LoRADense(4, 6, r=8, compute_dtype=torch.float32, device="cpu")
    assert tuple(dense.lora_a.shape) == (4, 8) and tuple(dense.lora_b.shape) == (8, 6)
    x = torch.randn(3, 4)
    torch.testing.assert_close(dense(x), x @ dense.weight.T, rtol=0, atol=0)


def test_w_ks_takes_no_lora_rank(monkeypatch):
    # the JAX layer builds the key projection with dense("w_ks", 0) whatever
    # lora_r is; record the rank each projection site asks for
    class Recorder(torch.nn.Module):
        def __init__(self, in_features, out_features, r=0, **kw):
            super().__init__()
            self.r = r

    monkeypatch.setattr(ttr, "LoRADense", Recorder)
    _, _, lms = configs()
    cfg = lms["coarse"][1].__class__(**{**lms["coarse"][1].__dict__, "lora_r": 8})
    attn = ttr.MultiHeadRelativeAttention(cfg.embedding_dim, cfg.n_heads, True, cfg,
                                          device="meta")
    assert {n: getattr(attn, n).r for n in ("w_qs", "w_ks", "w_vs", "fc")} == \
        {"w_qs": 8, "w_ks": 0, "w_vs": 8, "fc": 8}


# ---------------------------------------------------------------- x_mask

STACK_KW = dict(n_heads=2, n_layers=2, embedding_dim=32)


def _stack_pair(attention_impl="auto", seed=50):
    """A JAX `TransformerStack` (fp32, no dropout) with random numpy params,
    and the port's stack loaded from them."""
    import jax

    jstack = jtr.TransformerStack(n_heads=2, n_layers=2, dropout=0.0,
                                  attention_impl=attention_impl, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda key: jstack.init(key, jnp.zeros((1, 8, 32))),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "kernel":
                out[key] = (rng.standard_normal(val.shape) / np.sqrt(val.shape[0])).astype(np.float32)
            elif key == "weight":
                out[key] = (1.0 + 0.1 * rng.standard_normal(val.shape)).astype(np.float32)
            else:
                out[key] = rng.standard_normal(val.shape).astype(np.float32)
        return out

    params = fill(shapes)
    cfg = ttr.LMConfig(**STACK_KW, compute_dtype="float32", dropout=0.0,
                       attention_impl=attention_impl)
    stack = ttr.TransformerStack(cfg, device="cpu")
    stack.load_state_dict(lm_state_dict_from_jax(params, cfg), strict=True)
    return jstack, params, stack.requires_grad_(False), cfg


def _port_bias(stack, cfg, t):
    table = stack.layers_0.self_attn.relative_attention_bias
    rel = torch.arange(t)[None, :] - torch.arange(t)[:, None]
    buckets = ttr.relative_position_bucket(rel, True, cfg.attention_num_buckets,
                                           cfg.attention_max_distance)
    return table[buckets].permute(2, 0, 1).contiguous()


def _key_padding(b, t):
    valid = np.array([t, t - 9, t // 2][:b])
    m = np.arange(t)[None, None, :] < valid[:, None, None]
    return np.ascontiguousarray(np.broadcast_to(m, (b, t, t))).astype(np.int32)


@pytest.mark.parametrize("mask_rank", [3, 4])
def test_stack_with_x_mask_matches_jax_fp32(mask_rank):
    jstack, params, stack, cfg = _stack_pair()
    b, t = 3, 37
    rng = np.random.default_rng(51)
    x = rng.standard_normal((b, t, 32)).astype(np.float32)
    w = rng.standard_normal((b, t, 32)).astype(np.float32)
    mask = _key_padding(b, t)
    if mask_rank == 4:
        mask = mask[:, None]

    def jloss(x):
        out = jstack.apply({"params": to_jax(params)}, x, jnp.asarray(mask))
        return (out * jnp.asarray(w)).sum(), out

    (_, want), want_dx = jax_value_and_grad(jloss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = stack(tx, _port_bias(stack, cfg, t), x_mask=torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    # fp32 through 2 layers; the frameworks sum in different orders
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=2e-4, atol=2e-4)
    # the mask matters: without it the outputs move
    free = stack(torch.from_numpy(x), _port_bias(stack, cfg, t)).numpy()
    assert not np.allclose(free, np.asarray(want), atol=1e-3)


def jax_value_and_grad(f):
    import jax

    return jax.value_and_grad(f, has_aux=True)


def test_attention_impl_carried_over():
    assert ttr.LMConfig().attention_impl == jtr.LMConfig().attention_impl == "auto"
    jstack, params, stack, cfg = _stack_pair(attention_impl="xla", seed=52)
    assert all(getattr(stack, f"layers_{i}").self_attn.attention_impl == "xla" for i in range(2))
    b, t = 2, 29
    x = np.random.default_rng(53).standard_normal((b, t, 32)).astype(np.float32)
    mask = _key_padding(b, t)
    want = jstack.apply({"params": to_jax(params)}, jnp.asarray(x), jnp.asarray(mask))
    bias = _port_bias(stack, cfg, t)
    got = stack(torch.from_numpy(x), bias, x_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    # the kernels' route ("pallas"; on CPU tensors their plain versions) on
    # the same weights computes the same function
    _, _, pstack, pcfg = _stack_pair(attention_impl="pallas", seed=52)
    got_p = pstack(torch.from_numpy(x), bias, x_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="attention_impl"):
        ttr.TransformerStack(ttr.LMConfig(**STACK_KW, attention_impl="flash"), device="meta")
    rstack = ttr.TransformerStack(ttr.LMConfig(**STACK_KW, compute_dtype="float32",
                                               attention_impl="ring"), device="cpu")
    rstack.load_state_dict(stack.state_dict())
    # a ring stack runs only inside a RingStack over an sp mesh
    # (tests/test_torch_ring_attention.py), never as a whole-sequence stack
    with pytest.raises(RuntimeError, match="ring context"):
        rstack(torch.from_numpy(x), bias)
