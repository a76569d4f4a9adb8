"""Port parity for the serving slice: `generate` and the whole
`Interface.vamp_e2e`, against the JAX package on one numpy param tree, at
fp32 with the JAX XLA sampler.

The two packages draw different random numbers, so these runs use settings
in which no random draw decides a token: a full random mask
(`rand_mask_intensity=1`), no periodic prompt, no dropout, greedy sampling
(`sample_cutoff=-1`) and `mask_temperature=0`; a prefix and a suffix give
the model a prompt. Under those settings the tokens must be identical.

Every chunk row holds part of that prompt. A chunk with no prompt feeds every
position the same MASK embedding, attention averages identical values, and
the positions' confidences then differ only by float rounding: which of them
get re-masked would rest on ties, in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import codec_params_np, configs, lm_params_np, to_jax
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.interface import Interface as JInterface
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.sampling.generate import generate as jgenerate
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.codec import LAC
from vampnet_tpu_torch.interface import Interface
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.sampling.generate import generate

DETERMINISTIC = dict(rand_mask_intensity=1.0, periodic_prompt=0, _dropout=0.0,
                     sample_cutoff=-1.0, mask_temperature=0.0,
                     prefix_s=0.02, suffix_s=0.03)


@pytest.mark.parametrize("name", ["coarse", "c2f"])
def test_generate_token_identical_to_jax(name):
    _, _, lms = configs("float32")
    jcfg, tcfg = lms[name]
    params = lm_params_np(jcfg, 10)
    rng = np.random.default_rng(11)
    b, t = 3, 30
    z = rng.integers(0, jcfg.vocab_size, (b, jcfg.n_codebooks, t))
    mask = np.ones_like(z)
    mask[:, :, :4] = 0
    mask[:, : jcfg.n_conditioning_codebooks] = 0
    cbs = rng.standard_normal((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim)).astype(np.float32)
    kw = dict(n_conditioning_codebooks=jcfg.n_conditioning_codebooks, sampling_steps=6,
              temperature=1.0, mask_temperature=0.0, typical_filtering=True,
              typical_mass=0.3, typical_min_tokens=2, sample_cutoff=-1.0)

    jmodel, jparams = JVampNetLM(jcfg), to_jax(params)
    want = jgenerate(
        lambda zm: jmodel.apply({"params": jparams}, zm, jnp.asarray(cbs), method="forward_codes"),
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(mask), jcfg.mask_token,
        sampler_impl="xla", **kw)

    model = VampNetLM(tcfg, device="cpu")
    model.load_state_dict(convert.lm_state_dict_from_jax(params, tcfg))
    model.requires_grad_(False)
    tcbs = torch.from_numpy(cbs)
    got = generate(lambda zm: model.forward_codes(zm, tcbs), torch.from_numpy(z),
                   torch.from_numpy(mask), tcfg.mask_token, torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got == tcfg.mask_token).any()


@pytest.fixture(scope="module")
def interfaces():
    jc, tc, lms = configs("float32")
    codec_np = codec_params_np(jc, 20)
    coarse_np = lm_params_np(lms["coarse"][0], 21)
    c2f_np = lm_params_np(lms["c2f"][0], 22)
    # 75 / 25 tokens: 2 coarse chunks (prefix in one, suffix in the other),
    # 6 c2f chunks (the conditioning codebooks are their prompt)
    chunks = dict(coarse_chunk_size_s=0.15, coarse2fine_chunk_size_s=0.05)
    jiface = JInterface.from_modules(
        jc, to_jax(codec_np), lms["coarse"][0], to_jax(coarse_np),
        lms["c2f"][0], to_jax(c2f_np), **chunks)
    tiface = Interface.from_modules(
        tc, convert.codec_state_dict_from_jax(codec_np, tc),
        lms["coarse"][1], convert.lm_state_dict_from_jax(coarse_np, lms["coarse"][1]),
        lms["c2f"][1], convert.lm_state_dict_from_jax(c2f_np, lms["c2f"][1]),
        device="cpu", **chunks)
    return jiface, tiface


def _signal(seconds=0.3, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    left = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 660 * t)
    right = 0.4 * np.sin(2 * np.pi * 330 * t)
    noise = 0.02 * np.random.default_rng(0).standard_normal((2, len(t)))
    return (np.stack([left, right]) + noise)[None].astype(np.float32), sr


def _capture_decoded_codes(monkeypatch):
    """Record the codes each package hands its codec's decode_codes."""
    seen = {}
    j_orig, t_orig = JLAC.decode_codes, LAC.decode_codes

    def j_decode(self, codes):
        jax.debug.callback(lambda c: seen.__setitem__("jax", np.asarray(c)), codes)
        return j_orig(self, codes)

    def t_decode(self, codes):
        seen["torch"] = codes.cpu().numpy()
        return t_orig(self, codes)

    monkeypatch.setattr(JLAC, "decode_codes", j_decode)
    monkeypatch.setattr(LAC, "decode_codes", t_decode)
    return seen


@pytest.mark.parametrize("transfer_dtype,typical", [
    ("float32", dict()),  # typical_min_tokens 64 = vocab: the filter keeps all
    ("int16", dict(typical_mass=0.3, typical_min_tokens=2)),  # the filter cuts
])
def test_vamp_e2e_token_identical_to_jax(interfaces, monkeypatch, transfer_dtype, typical):
    jiface, tiface = interfaces
    seen = _capture_decoded_codes(monkeypatch)
    samples, sr = _signal()
    kw = dict(batch_size=2, seed=0, transfer_dtype=transfer_dtype, **DETERMINISTIC, **typical)
    want = jiface.vamp_e2e(JAudioSignal(samples, sr), **kw)
    got = tiface.vamp_e2e(AudioSignal(samples, sr), **kw)

    jcodes, tcodes = seen["jax"], seen["torch"]
    assert tcodes.shape == jcodes.shape == (2, 4, 150)
    np.testing.assert_array_equal(tcodes[:, :2], jcodes[:, :2])  # coarse codebooks
    np.testing.assert_array_equal(tcodes[:, 2:], jcodes[:, 2:])  # c2f codebooks
    assert got.samples.shape == want.samples.shape == (2, 1, 150 * 32)
    assert got.sample_rate == want.sample_rate == 16000
    if transfer_dtype == "int16":
        # both sides round the same waveform to 1/32767 steps; a sample on a
        # rounding boundary may land one step apart
        np.testing.assert_allclose(got.samples, want.samples, atol=1.5 / 32767, rtol=0)
    else:
        # fp32 decode of identical codes: summation order only
        np.testing.assert_allclose(got.samples, want.samples, rtol=1e-4, atol=1e-5)


def test_vamp_e2e_bf16_default_runs_and_is_reproducible():
    jc, tc, lms = configs("bfloat16")
    tiface = Interface.from_modules(
        tc, convert.codec_state_dict_from_jax(codec_params_np(jc, 30), tc),
        lms["coarse"][1], convert.lm_state_dict_from_jax(lm_params_np(lms["coarse"][0], 31), lms["coarse"][1]),
        lms["c2f"][1], convert.lm_state_dict_from_jax(lm_params_np(lms["c2f"][0], 32), lms["c2f"][1]),
        coarse_chunk_size_s=0.1, coarse2fine_chunk_size_s=0.05, device="cpu")
    samples, sr = _signal(0.2, 16000)
    out = tiface.vamp_e2e(AudioSignal(samples, sr), batch_size=3, seed=1, _sampling_steps=4)
    assert out.samples.shape == (3, 1, 100 * 32)
    assert np.isfinite(out.samples).all()
    again = tiface.vamp_e2e(AudioSignal(samples, sr), batch_size=3, seed=1, _sampling_steps=4)
    np.testing.assert_array_equal(out.samples, again.samples)  # seeded: reproducible
