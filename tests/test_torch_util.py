"""Port parity: token layout helpers, activations and mask algebra, plus the
shared builders the other `test_torch_*` files use.

Inputs come from numpy seeds; the JAX function and its port see the same
arrays. Integer and mask results must be identical; float results are held
to a tolerance stated at each assertion.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampnet_tpu import mask as jmask
from vampnet_tpu import util as jutil
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.modules.activations import new_gelu as jnew_gelu
from vampnet_tpu.modules.activations import snake as jsnake
from vampnet_tpu_torch import mask as tmask
from vampnet_tpu_torch import util as tutil
from vampnet_tpu_torch.codec import CodecConfig
from vampnet_tpu_torch.modules import LMConfig
from vampnet_tpu_torch.modules.activations import new_gelu, snake

# tiny shapes (the multichip dry run's sizes): hop 32 at 16 kHz, 4 codebooks
# of 64 entries; 4 heads of width 16, 2 layers
CODEC_KW = dict(sample_rate=16000, encoder_dim=16, encoder_rates=(2, 4, 4),
                decoder_dim=128, decoder_rates=(4, 4, 2), n_codebooks=4,
                codebook_size=64, codebook_dim=4)
LM_KW = dict(n_heads=4, n_layers=2, latent_dim=4, embedding_dim=64, vocab_size=64)
COARSE_KW = dict(LM_KW, n_codebooks=2, n_conditioning_codebooks=0)
C2F_KW = dict(LM_KW, n_codebooks=4, n_conditioning_codebooks=2)


def configs(compute_dtype="float32"):
    """(JAX codec cfg, port codec cfg, {name: (JAX lm cfg, port lm cfg)})."""
    lms = {
        name: (JLMConfig(dropout=0.0, compute_dtype=compute_dtype, **kw),
               LMConfig(compute_dtype=compute_dtype, **kw))
        for name, kw in (("coarse", COARSE_KW), ("c2f", C2F_KW))
    }
    return JCodecConfig(**CODEC_KW), CodecConfig(**CODEC_KW), lms


def _fill(shapes, rng, leaf_init):
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = _fill(val, rng, leaf_init)
        else:
            out[key] = leaf_init(key, tuple(val.shape), rng).astype(np.float32)
    return out


def _codec_leaf(name, shape, rng):
    if name == "v":  # weight norm g then sets each output's norm
        return rng.standard_normal(shape)
    if name == "g":  # < 1 keeps the residual stacks' activations O(1)
        return rng.uniform(0.3, 0.7, shape)
    if name == "alpha":
        return rng.uniform(0.5, 1.5, shape)
    if name == "bias":
        return 0.01 * rng.standard_normal(shape)
    return rng.standard_normal(shape)  # codebook


def _lm_leaf(name, shape, rng):
    if name == "kernel":
        return rng.standard_normal(shape) / np.sqrt(shape[0])
    if name == "weight":  # RMSNorm scale
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "bias":
        return 0.02 * rng.standard_normal(shape)
    return rng.standard_normal(shape)  # bucket table, MASK latents


def codec_params_np(jcfg, seed):
    """A random numpy param tree with the JAX codec's structure."""
    shapes = jax.eval_shape(
        JLAC(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jcfg.hop_length * 4, 1), jnp.float32))["params"]
    return _fill(shapes, np.random.default_rng(seed), _codec_leaf)


def lm_params_np(jcfg, seed):
    """A random numpy param tree with the JAX LM's structure."""
    model = JVampNetLM(jcfg)
    shapes = jax.eval_shape(
        lambda k: model.init(
            k, jnp.zeros((1, jcfg.n_codebooks, 8), jnp.int32),
            jnp.zeros((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim)),
            method="forward_codes"),
        jax.random.PRNGKey(0))["params"]
    return _fill(shapes, np.random.default_rng(seed), _lm_leaf)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------- util


def test_codebook_flatten_roundtrip_matches_jax():
    x = np.random.default_rng(0).integers(0, 100, (3, 4, 7))
    flat = tutil.codebook_flatten(torch.from_numpy(x))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jutil.codebook_flatten(jnp.asarray(x))))
    back = tutil.codebook_unflatten(flat, 4)
    np.testing.assert_array_equal(back.numpy(), x)


def test_scalar_to_batch_array():
    np.testing.assert_array_equal(tutil.scalar_to_batch_array(3, 4).numpy(), [3, 3, 3, 3])


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tutil.resolve_device("cuda")
    assert tutil.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------- activations


def test_activations_match_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 33)) * 3).astype(np.float32)
    alpha = rng.uniform(0.2, 2.0, (33,)).astype(np.float32)
    # fp32 elementwise math: a few ulp of tanh/sin differences between the
    # two libraries' CPU kernels
    np.testing.assert_allclose(new_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jnew_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        snake(torch.from_numpy(x), torch.from_numpy(alpha)).numpy(),
        np.asarray(jsnake(jnp.asarray(x), jnp.asarray(alpha))), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- mask


def _codes(b=2, c=4, t=23):
    return np.random.default_rng(2).integers(0, 64, (b, c, t))


@pytest.mark.parametrize("n_prefix,n_suffix", [(0, 0), (3, 0), (2, 5), (0, 4)])
def test_inpaint_matches_jax(n_prefix, n_suffix):
    x = _codes()
    np.testing.assert_array_equal(
        tmask.inpaint(torch.from_numpy(x), n_prefix, n_suffix).numpy(),
        np.asarray(jmask.inpaint(jnp.asarray(x), n_prefix, n_suffix)))


@pytest.mark.parametrize("period,width", [(0, 1), (1, 1), (3, 1), (7, 1), (5, 3), (4, 2)])
def test_periodic_mask_matches_jax(period, width):
    x = _codes()
    np.testing.assert_array_equal(
        tmask.periodic_mask(torch.from_numpy(x), period, width).numpy(),
        np.asarray(jmask.periodic_mask(jnp.asarray(x), period, width)))


def test_periodic_mask_random_roll_is_a_roll():
    x = torch.from_numpy(_codes())
    base = tmask.periodic_mask(x, 7, 1)
    g = torch.Generator().manual_seed(3)
    rolled = tmask.periodic_mask(x, 7, 1, random_roll=True, generator=g)
    assert any(torch.equal(torch.roll(base, s, dims=-1), rolled) for s in range(7))


def test_codebook_masks_and_mask_and_match_jax():
    m1 = np.random.default_rng(4).integers(0, 2, (2, 4, 11))
    m2 = np.random.default_rng(5).integers(0, 2, (2, 4, 11))
    t1, t2 = torch.from_numpy(m1), torch.from_numpy(m2)
    np.testing.assert_array_equal(tmask.codebook_mask(t1, 2).numpy(),
                                  np.asarray(jmask.codebook_mask(jnp.asarray(m1), 2)))
    np.testing.assert_array_equal(tmask.codebook_unmask(t1, 2).numpy(),
                                  np.asarray(jmask.codebook_unmask(jnp.asarray(m1), 2)))
    np.testing.assert_array_equal(tmask.mask_and(t1, t2).numpy(),
                                  np.asarray(jmask.mask_and(jnp.asarray(m1), jnp.asarray(m2))))


def test_linear_random_extremes_and_rate():
    x = torch.from_numpy(_codes(2, 4, 500))
    g = torch.Generator().manual_seed(0)
    assert int(tmask.linear_random(g, x, 1.0).min()) == 1
    assert int(tmask.linear_random(g, x, 0.0).max()) == 0
    rate = tmask.linear_random(g, x, torch.tensor([0.25, 0.75])).float().mean(dim=(1, 2))
    # 2000 Bernoulli draws per row: 5 standard deviations is < 0.05
    np.testing.assert_allclose(rate.numpy(), [0.25, 0.75], atol=0.05)


def test_dropout_only_adds_regenerated_steps():
    m = torch.zeros((1, 3, 40), dtype=torch.int64)
    g = torch.Generator().manual_seed(1)
    out = tmask.dropout(g, m, 0.25)
    steps = out[0, 0]
    assert 1 <= int(steps.sum()) <= 10 and torch.equal(out, out[:, :1].expand_as(out))
    assert torch.equal(tmask.dropout(g, m, 0.0), m)


def test_gamma_matches_jax():
    r = np.linspace(0, 1, 13, dtype=np.float32)
    np.testing.assert_array_equal(tmask._gamma(torch.from_numpy(r)).numpy(),
                                  np.asarray(jmask._gamma(jnp.asarray(r))))
