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
    with pytest.raises(NotImplementedError):
        LoRADense(4, 4, r=8, device="cpu")


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
