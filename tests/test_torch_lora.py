"""Port parity: LoRA adapters at r > 0 (`vampnet_tpu_torch/modules/lora.py`)
against the JAX package's `LoRADense` and its adapter-tree functions, and a
`VampNetLM` at `lora_r=2` against the JAX LM.

The layer computes y + (x A) B * alpha / r in its compute dtype after the
float product, or after the w8a8 product with `quantize=True`. Inputs are
numpy-seeded; each tolerance is stated where it is asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import configs, lm_params_np, to_jax
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.modules import lora as jlora
from vampnet_tpu_torch.convert import lm_params_to_jax, lm_state_dict_from_jax
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.modules import lora as tlora
from vampnet_tpu_torch.util import flatten_tree, unflatten_tree

D_IN, D_OUT, R = 48, 40, 4


def _layer_params(rng, quantize):
    a = rng.standard_normal((D_IN, R)) / np.sqrt(D_IN)
    b = 0.5 * rng.standard_normal((R, D_OUT))
    if quantize:
        p = dict(kernel_q=rng.integers(-127, 128, (D_IN, D_OUT)).astype(np.int8),
                 kernel_scale=rng.uniform(1e-3, 1e-2, D_OUT).astype(np.float32))
    else:
        p = dict(kernel=(rng.standard_normal((D_IN, D_OUT)) / np.sqrt(D_IN)).astype(np.float32))
    return dict(p, lora_a=a.astype(np.float32), lora_b=b.astype(np.float32))


def _port_layer(params, dtype, quantize):
    layer = tlora.LoRADense(D_IN, D_OUT, r=R, compute_dtype=getattr(torch, dtype),
                            quantize=quantize, device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in params.items() if k.startswith("lora")}
    if quantize:
        sd.update(w_q=torch.from_numpy(params["kernel_q"].T.copy()),
                  w_scale=torch.from_numpy(params["kernel_scale"]))
    else:
        sd["weight"] = torch.from_numpy(params["kernel"].T.copy())
    layer.load_state_dict(sd, strict=True)
    return layer.requires_grad_(False)


@pytest.mark.parametrize("dtype,quantize", [("float32", False), ("bfloat16", False),
                                            ("float32", True), ("bfloat16", True)])
def test_lora_dense_matches_jax(dtype, quantize):
    rng = np.random.default_rng(0)
    params = _layer_params(rng, quantize)
    x = rng.standard_normal((3, 7, D_IN)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jlayer = jlora.LoRADense(features=D_OUT, r=R, dtype=jdt, quantize=quantize)
    jx = jnp.asarray(x).astype(jdt)
    want = np.asarray(jlayer.apply({"params": to_jax(params)}, jx).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    layer = _port_layer(params, dtype, quantize)
    got = layer(tx)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        # fp32 products summed in other orders (the w8a8 part is exact)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # bf16 results: 8 bits of mantissa, a rounding apart at most twice
        np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2 ** -6)

    if quantize:  # lora_b = 0: the w8a8 product alone, bit for bit
        params = dict(params, lora_b=np.zeros_like(params["lora_b"]))
        want0 = jlayer.apply({"params": to_jax(params)}, jx).astype(jnp.float32)
        got0 = _port_layer(params, dtype, quantize)(tx).float().numpy()
        np.testing.assert_array_equal(got0, np.asarray(want0))


def _tree():
    jcfg = dataclasses.replace(configs("float32")[2]["coarse"][0], lora_r=2)
    return jcfg, lm_params_np(jcfg, 7)


def test_adapter_tree_functions_match_jax():
    _, tree = _tree()
    want_filter = flatten_tree(jlora.lora_param_filter(to_jax(tree)))
    assert flatten_tree(tlora.lora_param_filter(tree)) == want_filter
    assert sum(want_filter.values()) == 2 * 5 * 2  # 5 adapter sites, 2 layers

    want = flatten_tree(jlora.lora_state_dict(to_jax(tree)))
    got = flatten_tree(tlora.lora_state_dict(tree))
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_array_equal(got[path], np.asarray(want[path]))

    # overlay shifted adapters on a bf16 tree: cast to the tree's dtype
    base = {p: torch.from_numpy(x).to(torch.bfloat16) for p, x in flatten_tree(tree).items()}
    over = {p: torch.from_numpy(np.asarray(x) + 1.0) for p, x in want.items()}
    over[("transformer", "not_a_layer", "lora_a")] = torch.ones(2)  # ignored
    merged = flatten_tree(tlora.merge_lora_state_dict(unflatten_tree(base),
                                                      unflatten_tree(over)))
    jmerged = flatten_tree(jlora.merge_lora_state_dict(
        unflatten_tree({p: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                        for p, x in base.items()}),
        unflatten_tree({p: jnp.asarray(x.numpy()) for p, x in over.items()})))
    assert set(merged) == set(jmerged) == set(base)
    for path, x in merged.items():
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(), np.asarray(jmerged[path], np.float32))


def test_vampnet_lm_logits_at_rank_2_match_jax():
    jcfg, tree = _tree()
    tcfg = dataclasses.replace(configs("float32")[2]["coarse"][1], lora_r=2)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, jcfg.vocab_size + 1, (2, jcfg.n_codebooks, 29))  # incl. MASK
    cbs = rng.standard_normal((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim))
    cbs = cbs.astype(np.float32)
    jlm = JVampNetLM(jcfg)
    want = np.asarray(jlm.apply({"params": to_jax(tree)}, jnp.asarray(codes), jnp.asarray(cbs),
                                method="forward_codes"))
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_jax(tree, tcfg), strict=True)
    got = lm.forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs)).detach().numpy()
    # fp32 through 2 layers, as tests/test_torch_lm.py holds the plain LM
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the adapters move the logits: zeroing them changes the output
    zeroed = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.zeros_like(x) if p[-1].key == "lora_b" else x, to_jax(tree))
    off = np.asarray(jlm.apply({"params": zeroed}, jnp.asarray(codes), jnp.asarray(cbs),
                               method="forward_codes"))
    assert np.abs(off - want).max() > 100 * 2e-4
    # the reverse bridge gives the adapters back untouched
    back = flatten_tree(lm_params_to_jax(lm.state_dict()))
    for path, x in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[path], x)
