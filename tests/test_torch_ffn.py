"""Port parity: the fused-FFN serving option. The fused kernel's plain version
against the JAX package's Pallas kernel (interpret mode), and an LM with
`ffn_impl="fused"` against the JAX LM with the same option, on one numpy
param tree; the option refuses what the JAX package refuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import configs, lm_params_np, to_jax
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.modules.quantize import quantize_lm_params
from vampnet_tpu.ops.ffn_kernel import fused_geglu_ffn as jfused
from vampnet_tpu_torch.convert import lm_state_dict_from_jax
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.ops.ffn_kernel import fused_geglu_ffn, fused_geglu_ffn_plain

D = 64


def _ffn_inputs(b, t, seed):
    """x (b, t, D), nw (D,), and the JAX kernels w1 (D, 4D), w2 (2D, D)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, D)) * 2.0).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    w1 = (rng.standard_normal((D, 4 * D)) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.standard_normal((2 * D, D)) / np.sqrt(2 * D)).astype(np.float32)
    return x, nw, w1, w2


@pytest.mark.parametrize("b,t", [(1, 37), (3, 101)])  # m = 303: two 256-row blocks, ragged
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ffn_plain_matches_pallas(b, t, dtype):
    x, nw, w1, w2 = _ffn_inputs(b, t, seed=t)
    jdt = getattr(jnp, dtype)
    jx = jnp.asarray(x).astype(jdt)
    want = jfused(jx, jnp.asarray(nw), jnp.asarray(w1), jnp.asarray(w2), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = fused_geglu_ffn_plain(tx, torch.from_numpy(nw), torch.from_numpy(w1.T.copy()),
                                torch.from_numpy(w2.T.copy()))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        # the same steps in fp32; the hidden sums in other orders
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        # the same roundings (y and g to bf16, the output to bf16); the fp32
        # sums in other orders can move a rounded y or g by one bf16 ulp,
        # which the output carries at about 2^-8 of its size
        tol = dict(rtol=2 ** -6, atol=2 ** -6)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_fused_ffn_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    x, nw, w1, w2 = (torch.from_numpy(a) for a in _ffn_inputs(2, 9, seed=1))
    w1, w2 = w1.T.contiguous(), w2.T.contiguous()
    before = fused_geglu_ffn.launches
    assert torch.equal(fused_geglu_ffn(x, nw, w1, w2), fused_geglu_ffn_plain(x, nw, w1, w2))
    assert fused_geglu_ffn.launches == before


def _lms(name, compute_dtype, seed, **kw):
    """(JAX fused config, port fused config, numpy params) at tiny width."""
    _, _, lms = configs(compute_dtype)
    jcfg, tcfg = lms[name]
    params = lm_params_np(jcfg, seed)
    return (dataclasses.replace(jcfg, ffn_impl="fused", **kw),
            dataclasses.replace(tcfg, ffn_impl="fused", **kw), params)


def _logits_pair(name, compute_dtype, t, seed):
    jcfg, tcfg, params = _lms(name, compute_dtype, seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, jcfg.vocab_size + 1, (2, jcfg.n_codebooks, t))
    cbs = rng.standard_normal((jcfg.n_codebooks, jcfg.vocab_size,
                               jcfg.latent_dim)).astype(np.float32)
    want = np.asarray(JVampNetLM(jcfg).apply(
        {"params": to_jax(params)}, jnp.asarray(codes), jnp.asarray(cbs), method="forward_codes"))
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_jax(params, tcfg), strict=True)
    with torch.no_grad():
        got = lm.forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs)).numpy()
    return got, want, lm, (torch.from_numpy(codes), torch.from_numpy(cbs))


@pytest.mark.parametrize("name,t", [("coarse", 37), ("c2f", 25)])
def test_fused_lm_logits_match_jax_fp32(name, t):
    got, want, _, _ = _logits_pair(name, "float32", t, seed=20)
    # fp32 end to end through 2 layers, the fused FFN on both sides
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fused_lm_logits_match_jax_bf16():
    got, want, _, _ = _logits_pair("coarse", "bfloat16", 37, seed=30)
    # bf16 activations through 2 layers: a bf16 ulp (2^-8) moved in one place
    # spreads through the next products; logits are O(1)-O(10)
    err = np.abs(got - want)
    assert float(err.max()) <= 0.1 * float(np.abs(want).max()), float(err.max())
    assert float(err.mean()) <= 0.01 * float(np.abs(want).mean()), float(err.mean())


def test_fused_lm_keeps_the_unfused_state_dict_and_stays_close_to_it():
    _, tcfg, params = _lms("coarse", "float32", 40)
    fused = VampNetLM(tcfg, device="cpu")
    unfused = VampNetLM(dataclasses.replace(tcfg, ffn_impl="auto"), device="cpu")
    assert fused.state_dict().keys() == unfused.state_dict().keys()
    sd = lm_state_dict_from_jax(params, tcfg)
    fused.load_state_dict(sd, strict=True)
    unfused.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(41)
    codes = torch.from_numpy(rng.integers(0, 65, (2, 2, 30)))
    cbs = torch.from_numpy(rng.standard_normal((2, 64, 4)).astype(np.float32))
    with torch.no_grad():
        a, b = fused.forward_codes(codes, cbs), unfused.forward_codes(codes, cbs)
    # fp32: the same function, summed in other orders
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_fused_refuses_dropout_lora_and_int8_as_jax_does():
    jcfg, tcfg, params = _lms("coarse", "float32", 50)
    codes = jnp.zeros((1, jcfg.n_codebooks, 8), jnp.int32)
    cbs = jnp.zeros((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim))
    with pytest.raises(ValueError, match="fused"):
        JVampNetLM(jcfg).apply({"params": to_jax(params)}, codes, cbs, deterministic=False,
                               method="forward_codes", rngs={"dropout": jax.random.PRNGKey(0)})
    qcfg = dataclasses.replace(jcfg, quantization="int8")
    with pytest.raises(ValueError, match="fused"):
        JVampNetLM(qcfg).apply({"params": quantize_lm_params(to_jax(params))}, codes, cbs,
                               method="forward_codes")
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_jax(params, tcfg))
    with pytest.raises(ValueError, match="fused"):
        lm.forward_codes(torch.zeros((1, 2, 8), dtype=torch.int64), torch.zeros((2, 64, 4)),
                         generator=torch.Generator().manual_seed(0))
    for kw in (dict(lora_r=8), dict(quantization="int8")):
        with pytest.raises(ValueError, match="fused"):
            VampNetLM(dataclasses.replace(tcfg, **kw), device="meta")
    with pytest.raises(ValueError, match="ffn_impl"):
        VampNetLM(dataclasses.replace(tcfg, ffn_impl="pallas"), device="meta")
