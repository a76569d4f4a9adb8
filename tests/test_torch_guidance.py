"""Port parity: the sampling options `top_k` and `cfg_guidance` (the sampler
kernel's plain version, `generate`, and the staged Interface API), against
the JAX package on one numpy param tree, at fp32.

As in `test_torch_e2e.py`, the two packages draw different random numbers,
so the token comparisons run where no draw decides a token: greedy sampling
(`sample_cutoff=-1`), `mask_temperature=0`, a prompt in every row. Under
greedy sampling `top_k` still changes the chosen tokens' probabilities, and
so the re-masking order.

`cfg_guidance`'s unconditional rows are all MASK, the tie case of
`test_torch_e2e.py`: every position of such a row sees the same embedding,
so its logits agree across positions up to float rounding, and from the
second step on which of its positions are re-masked rests on ties. One step
(nothing is re-masked at the last) is held token for token. Several steps
are held token for token where both packages scale their logits by the
same per-position factor (`_position_scale`), which ranks the tied
positions apart, and to a share of differing tokens where they do not.
The unconditional rows' keys are not compared with JAX's (the packages
draw from different generators); their use is held by
`test_cfg_guidance_solo_equals_batched_with_row_keys`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_interface_staged import GREEDY, _codes, _pair, _prompt_mask
from test_torch_util import configs, lm_params_np, to_jax
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.sampling import sample as jsample
from vampnet_tpu.sampling.generate import generate as jgenerate
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits, fused_sample_plain
from vampnet_tpu_torch.sampling.generate import generate

# the share of a two-step cfg_guidance run's tokens that may differ from
# JAX's: the unconditional rows' re-masking after step 1 rests on float ties
# (the module docstring). Measured on these inputs: 0.29 (coarse), 0.34
# (coarse, top_k 4), 0.03 (c2f), 0.04 (c2f, top_k 4); at 4 steps 0.52 to
# 0.57 for coarse. Without cfg_guidance the same runs agree token for token,
# and with the ties broken (`_position_scale`) so do the guided ones.
CFG_TWO_STEP_BOUND = 0.4


def _quantized_logits(shape, seed, step=0.5):
    """Normal logits rounded to multiples of `step`: many ties, at the k-th
    value too."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.standard_normal(shape) * 3.0 / step) * step).astype(np.float32)


@pytest.mark.parametrize("top_k", [1, 8, 64, 1024])
@pytest.mark.parametrize("typical,top_p", [(False, None), (True, None), (False, 0.9),
                                           (True, 0.9)])
def test_top_k_in_the_sampler_plain_version_matches_jax(top_k, typical, top_p):
    """Greedy tokens and their probabilities after typical -> top-k -> top-p,
    with ties at the k-th value; with the typical filter fewer than k tokens
    often survive (top-k then changes nothing)."""
    logits = _quantized_logits((2, 40, 1024), seed=top_k)
    kw = dict(typical_filtering=typical, typical_mass=0.15, typical_min_tokens=4)
    jtok, jprob = jsample.sample_from_logits(
        jax.random.PRNGKey(0), jnp.asarray(logits), sample=False, temperature=0.7,
        top_k=top_k, top_p=top_p, return_probs=True, **kw)
    keys = torch.zeros((2, 2), dtype=torch.int64)
    tok, prob = fused_sample_from_logits(
        keys, 0, torch.from_numpy(logits), 0.7, 0.0, top_p=top_p, use_top_p=top_p is not None,
        top_k=top_k, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    # fp32 softmax over the same kept set, summed in another order
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=1e-5, atol=1e-7)
    tok_off, prob_off = fused_sample_plain(keys, 0, torch.from_numpy(logits), 0.7, 0.0,
                                           top_p=top_p, use_top_p=top_p is not None, **kw)
    assert torch.equal(tok_off, tok)  # greedy: the argmax always survives
    if not typical and top_k < 1024:  # the filter cut the kept set
        assert not torch.equal(prob_off, prob)
    elif typical and top_k >= 64:  # fewer than k survive the typical filter
        assert torch.equal(prob_off, prob)


def _lm(name, seed=50):
    _, _, lms = configs("float32")
    jcfg, tcfg = lms[name]
    params = lm_params_np(jcfg, seed)
    model = VampNetLM(tcfg, device="cpu")
    model.load_state_dict(convert.lm_state_dict_from_jax(params, tcfg))
    return jcfg, tcfg, params, model.requires_grad_(False)


def _problem(jcfg, b=3, t=30, seed=51):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, jcfg.vocab_size, (b, jcfg.n_codebooks, t))
    mask = np.ones_like(z)
    mask[:, :, :4] = 0
    mask[:, :, ::7] = 0
    mask[:, : jcfg.n_conditioning_codebooks] = 0
    cbs = rng.standard_normal((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim))
    return z, mask, cbs.astype(np.float32)


def _position_scale(t, n_infer):
    """A per-position scale of the logits, (1, t, n_infer, 1), rising from 1
    to 1.05 in flat order: a softmax's top probability then rises with the
    position, so that positions whose logits agree (the all-MASK rows) are
    ranked apart by far more than float rounding. An additive offset would
    not do: the softmax ignores it."""
    flat = np.arange(t * n_infer, dtype=np.float32).reshape(1, t, n_infer, 1)
    return (1.0 + 0.05 * flat / (t * n_infer)).astype(np.float32)


def _both(name, steps, break_ties=False, **kw):
    """(JAX tokens, port tokens) of one generate call at greedy settings;
    with `break_ties` both forwards scale their logits by
    `_position_scale`."""
    jcfg, tcfg, params, model = _lm(name)
    z, mask, cbs = _problem(jcfg)
    scale = (_position_scale(z.shape[-1], jcfg.n_codebooks - jcfg.n_conditioning_codebooks)
             if break_ties else np.ones((1, 1, 1, 1), np.float32))
    jscale, tscale = jnp.asarray(scale), torch.from_numpy(scale)
    kw = dict(n_conditioning_codebooks=jcfg.n_conditioning_codebooks, sampling_steps=steps,
              temperature=1.0, mask_temperature=0.0, typical_filtering=True,
              typical_mass=0.3, typical_min_tokens=2, sample_cutoff=-1.0, **kw)
    jmodel, jparams = JVampNetLM(jcfg), to_jax(params)
    want = jgenerate(
        lambda zm: jscale * jmodel.apply({"params": jparams}, zm, jnp.asarray(cbs),
                                         method="forward_codes"),
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(mask), jcfg.mask_token,
        sampler_impl="xla", **kw)
    tcbs = torch.from_numpy(cbs)
    with torch.inference_mode():
        got = generate(lambda zm: tscale * model.forward_codes(zm, tcbs), torch.from_numpy(z),
                       torch.from_numpy(mask), tcfg.mask_token,
                       torch.Generator().manual_seed(0), **kw)
    assert not (got == tcfg.mask_token).any() and got.shape == z.shape
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name,top_k", [("coarse", 5), ("c2f", 3), ("coarse", 1)])
def test_generate_with_top_k_token_identical_to_jax(name, top_k):
    want, got = _both(name, 6, top_k=top_k)
    np.testing.assert_array_equal(got, want)
    # top_k moved the re-masking order, and so the tokens
    _, free = _both(name, 6)
    assert not np.array_equal(free, got)


@pytest.mark.parametrize("name", ["coarse", "c2f"])
def test_cfg_guidance_one_step_token_identical_to_jax(name):
    want, got = _both(name, 1, cfg_guidance=3.0)
    np.testing.assert_array_equal(got, want)
    _, plain = _both(name, 1)
    assert not np.array_equal(plain, got)  # the guidance moved tokens


@pytest.mark.parametrize("name,steps,extra", [("coarse", 2, {}), ("coarse", 4, {}),
                                              ("coarse", 4, dict(top_k=4)),
                                              ("c2f", 2, dict(top_k=4))])
def test_cfg_guidance_several_steps_token_identical_with_ties_broken(name, steps, extra):
    """With the ties of the unconditional rows broken the same way in both
    packages (`_position_scale`), several steps agree token for token: the
    unconditional rows' N0 of n_cb * t and their re-masking are held to
    JAX's."""
    want, got = _both(name, steps, break_ties=True, cfg_guidance=2.0, **extra)
    np.testing.assert_array_equal(got, want)
    _, plain = _both(name, steps, break_ties=True, **extra)
    assert not np.array_equal(plain, got)  # the guidance moved tokens


@pytest.mark.parametrize("name,extra", [("coarse", {}), ("c2f", dict(top_k=4))])
def test_cfg_guidance_several_steps_within_a_share_of_jax(name, extra):
    want, got = _both(name, 2, cfg_guidance=2.0, **extra)
    share = float((got != want).mean())
    assert share <= CFG_TWO_STEP_BOUND, share
    want, got = _both(name, 2, **extra)  # the same run without the guidance: no ties
    np.testing.assert_array_equal(got, want)


def test_cfg_guidance_with_per_row_params():
    """Per-row (nb,) parameters are tiled over the appended unconditional
    rows; only the nb rows come back (the counterpart of
    `tests/test_sampling.py::test_generate_cfg_guidance_with_per_row_params`)."""
    jcfg, tcfg, _, model = _lm("coarse")
    z, _, cbs = _problem(jcfg, b=2, t=8)
    tcbs = torch.from_numpy(cbs)
    seen = []

    def forward(zm):
        seen.append(zm.shape[0])
        return model.forward_codes(zm, tcbs)

    out = generate(forward, torch.from_numpy(z), torch.ones((2, 2, 8), dtype=torch.int64),
                   tcfg.mask_token, torch.Generator().manual_seed(0), sampling_steps=3,
                   cfg_guidance=1.5, temperature=torch.tensor([0.8, 1.2]),
                   mask_temperature=torch.tensor([10.5, 4.0]), top_p=torch.tensor([0.9, 0.8]),
                   sample_cutoff=torch.tensor([1.0, 0.5]), top_k=10)
    assert out.shape == z.shape and seen == [4, 4, 4]
    assert (out != tcfg.mask_token).all() and (out >= 0).all() and (out < tcfg.vocab_size).all()


def test_cfg_guidance_solo_equals_batched_with_row_keys():
    """Each request's rows, the unconditional one included, draw from their
    own keys (sampling on): alone or batched, the same tokens."""
    jcfg, tcfg, _, model = _lm("coarse")
    z, mask, cbs = _problem(jcfg, b=3, t=24)
    tcbs = torch.from_numpy(cbs)
    keys = torch.from_numpy(np.random.default_rng(5).integers(0, 2 ** 32, (3, 2)))
    temp = torch.tensor([0.8, 1.0, 1.3])

    def run(rows, keys=keys):
        with torch.inference_mode():
            return generate(lambda zm: model.forward_codes(zm, tcbs), torch.from_numpy(z[rows]),
                            torch.from_numpy(mask[rows]), tcfg.mask_token, row_keys=keys[rows],
                            temperature=temp[rows], sampling_steps=4, typical_mass=0.3,
                            typical_min_tokens=2, cfg_guidance=2.5, top_k=16)

    batched = run([0, 1, 2])
    for i in range(3):
        torch.testing.assert_close(run([i])[0], batched[i], rtol=0, atol=0)
    assert not torch.equal(run([0, 1, 2], keys + 1), batched)


def test_cfg_guidance_needs_controls_for_every_forward_row():
    """With `ctrls` as well, the forward runs the doubled batch: controls of
    nb rows fail, as JAX's shapes do."""
    jcfg, tcfg, _, model = _lm("coarse")
    z, mask, cbs = _problem(jcfg, b=2, t=8)
    ctrls = {"rms": torch.zeros((2, 8, 1))}
    with pytest.raises(ValueError, match="rows"):
        generate(lambda zm, c, cm: None, torch.from_numpy(z), torch.from_numpy(mask),
                 tcfg.mask_token, torch.Generator(), cfg_guidance=2.0, ctrls=ctrls,
                 ctrl_masks={"rms": torch.ones((2, 8))})


@pytest.fixture(scope="module")
def interfaces():
    return _pair()


@pytest.mark.parametrize("kw", [dict(top_k=5), dict(cfg_guidance=3.0),
                                dict(top_k=5, cfg_guidance=3.0)])
def test_staged_vamp_with_top_k_and_cfg_guidance_matches_jax(interfaces, kw):
    """`vamp` passes both knobs to the coarse stage (the c2f stage takes
    neither, as in JAX); `coarse_vamp` and `coarse_to_fine` take them too."""
    jiface, tiface = interfaces
    jz, tz = _codes(jiface, tiface)
    mask = _prompt_mask(jz.shape, 3)
    steps = 1 if "cfg_guidance" in kw else 4
    want = np.asarray(jiface.vamp(jnp.asarray(jz), jnp.asarray(mask), batch_size=2, seed=7,
                                  _sampling_steps=steps, **GREEDY, **kw))
    got = tiface.vamp(tz, torch.from_numpy(mask), batch_size=2, seed=7, _sampling_steps=steps,
                      **GREEDY, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    jc = np.asarray(jiface.coarse_to_fine(jnp.asarray(jz), seed=3, _sampling_steps=1, **GREEDY,
                                          **kw))
    tc = tiface.coarse_to_fine(tz, seed=3, _sampling_steps=1, **GREEDY, **kw)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_top_k_out_of_range_raises_through_the_staged_api(interfaces):
    _, tiface = interfaces
    z = torch.zeros((1, 4, 30), dtype=torch.int64)
    with pytest.raises(ValueError, match="top_k"):
        tiface.vamp(z, torch.ones_like(z), top_k=0, _sampling_steps=1)
