"""Port parity: the staged Interface API (`encode`, `build_mask`,
`set_chunk_size`, `coarse_vamp`, `coarse_to_fine`, `vamp`, `decode`), the
sequence the JAX package's serving apps run, against the JAX `Interface` on
one numpy param tree, at fp32.

As in `test_torch_e2e.py`, the two packages draw different random numbers,
so the token comparisons run settings in which no draw decides a token
(greedy sampling, `mask_temperature=0`, masks that need no draw), and every
chunk row holds part of a prompt (see that file on ties in all-MASK chunks).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_e2e import DETERMINISTIC, _signal
from test_torch_util import CODEC_KW, codec_params_np, configs, lm_params_np, to_jax
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.interface import Interface as JInterface
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.codec import CodecConfig
from vampnet_tpu_torch.interface import Interface
from vampnet_tpu_torch.ops import flash_attention as fa

# greedy, no re-masking noise: the settings of DETERMINISTIC that sampling reads
GREEDY = dict(sample_cutoff=DETERMINISTIC["sample_cutoff"],
              mask_temperature=DETERMINISTIC["mask_temperature"])


def _pair(sample_rate=16000, coarse_chunk_s=0.15, c2f_chunk_s=0.05, coarse_impl="auto"):
    """(JAX Interface, port Interface on the CPU) from one numpy param tree;
    the port's coarse LM takes `coarse_impl` as its attention route."""
    codec_kw = dict(CODEC_KW, sample_rate=sample_rate)
    jc, tc = JCodecConfig(**codec_kw), CodecConfig(**codec_kw)
    _, _, lms = configs("float32")
    codec_np = codec_params_np(jc, 60)
    coarse_np = lm_params_np(lms["coarse"][0], 61)
    c2f_np = lm_params_np(lms["c2f"][0], 62)
    chunks = dict(coarse_chunk_size_s=coarse_chunk_s, coarse2fine_chunk_size_s=c2f_chunk_s)
    jiface = JInterface.from_modules(jc, to_jax(codec_np), lms["coarse"][0], to_jax(coarse_np),
                                     lms["c2f"][0], to_jax(c2f_np), **chunks)
    tcoarse = dataclasses.replace(lms["coarse"][1], attention_impl=coarse_impl)
    tc2f = lms["c2f"][1]
    tiface = Interface.from_modules(
        tc, convert.codec_state_dict_from_jax(codec_np, tc),
        tcoarse, convert.lm_state_dict_from_jax(coarse_np, tcoarse),
        tc2f, convert.lm_state_dict_from_jax(c2f_np, tc2f), device="cpu", **chunks)
    return jiface, tiface


@pytest.fixture(scope="module")
def interfaces():
    return _pair()


def _codes(jiface, tiface, seconds=0.3, sr=22050):
    samples, sr = _signal(seconds, sr)
    jz = np.asarray(jiface.encode(JAudioSignal(samples, sr)))
    tz = tiface.encode(AudioSignal(samples, sr))
    return jz, tz


def _prompt_mask(shape, every, upper=None):
    """1 everywhere but every `every`-th step (a prompt in every chunk),
    codebooks >= upper regenerated throughout."""
    m = np.ones(shape, np.int64)
    m[:, :upper, ::every] = 0
    return m


def test_encode_and_decode_match_jax(interfaces):
    jiface, tiface = interfaces
    jz, tz = _codes(jiface, tiface)
    assert tz.dtype == torch.int64 and tz.device.type == "cpu"
    np.testing.assert_array_equal(tz.numpy(), jz)
    z = jz.copy()
    mask_token = tiface.coarse.mask_token
    z[:, :, 10:14] = mask_token  # every codebook MASK: these frames are silenced
    z[:, 1, 20:30] = mask_token  # one codebook MASK: decoded as code 0
    want = jiface.decode(jnp.asarray(z))
    got = tiface.decode(z)
    assert got.samples.shape == want.samples.shape == (1, 1, z.shape[-1] * 32)
    assert got.sample_rate == want.sample_rate
    assert not got.samples[..., 10 * 32:14 * 32].any()
    # fp32 decode of identical codes: summation order only
    np.testing.assert_allclose(got.samples, want.samples, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(prefix_s=0.02, suffix_s=0.03, periodic_prompt=0, upper_codebook_mask=3),
    dict(prefix_s=0.0, suffix_s=0.05, periodic_prompt=1, upper_codebook_mask=1, ncc=1),
    dict(rand_mask_intensity=0.0, periodic_prompt=0, upper_codebook_mask=2, ncc=2),
])
def test_deterministic_build_mask_matches_jax(interfaces, kw):
    jiface, tiface = interfaces
    jz, tz = _codes(jiface, tiface)
    want = np.asarray(jiface.build_mask(jnp.asarray(jz), seed=3, **kw))
    got = tiface.build_mask(tz, seed=3, **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pin_edges", [True, False])
def test_chunk_helpers_match_jax(interfaces, pin_edges):
    jiface, tiface = interfaces
    rng = np.random.default_rng(5)
    b, n_cb, t, chunk_len = 2, 3, 47, 10  # 5 chunks, the last padded by 3
    cz = rng.integers(0, 64, (b, n_cb, t))
    m = (rng.random((b, n_cb, t)) < 0.8).astype(np.int64)
    m[:, :, 20:30] = 1  # chunk 2 keeps nothing: it is not pinned
    (jpre, jpost), jn = jiface._chunk_fns("coarse", n_cb, b, t, chunk_len, 64, pin_edges)
    (pre, post), n = tiface._chunk_fns(n_cb, b, t, chunk_len, 64, pin_edges)
    assert n == jn == 5
    want = [np.asarray(x) for x in jpre(jnp.asarray(cz), jnp.asarray(m))]
    got = pre(torch.from_numpy(cz), torch.from_numpy(m))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(post(got[0]).numpy(), np.asarray(jpost(jnp.asarray(want[0]))))


def test_coarse_vamp_in_several_chunks_matches_jax(interfaces):
    jiface, tiface = interfaces
    jz, tz = _codes(jiface, tiface)
    for iface in (jiface, tiface):
        iface.set_chunk_size(0.04)  # 20 tokens: 150 tokens are 8 chunks, 10 padded
    try:
        assert tiface.s2t(tiface.coarse.chunk_size_s) == 20
        mask = _prompt_mask(jz.shape, 7)
        kw = dict(_sampling_steps=4, seed=1, return_mask=True, **GREEDY)
        want, want_masked = jiface.coarse_vamp(jnp.asarray(jz), jnp.asarray(mask), **kw)
        got, got_masked = tiface.coarse_vamp(tz, mask, **kw)
    finally:
        for iface in (jiface, tiface):
            iface.set_chunk_size(0.15)
    np.testing.assert_array_equal(got_masked.numpy(), np.asarray(want_masked))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the fine codebooks come back from z; chunk edges were pinned (kept)
    np.testing.assert_array_equal(got[:, 2:].numpy(), jz[:, 2:])
    assert (got_masked[:, :, 19] != tiface.coarse.mask_token).all()


def test_vamp_with_batch_feedback_and_time_stretch_matches_jax(interfaces):
    jiface, tiface = interfaces
    jz, tz = _codes(jiface, tiface)
    mask = _prompt_mask(jz.shape, 6, upper=3)
    # a per-request temperature is tiled over the chunk rows (greedy: it
    # decides nothing, but both packages must take its shape)
    kw = dict(batch_size=2, feedback_steps=2, time_stretch_factor=2, return_mask=True,
              seed=7, _sampling_steps=4, temperature=np.array([1.0, 0.8], np.float32),
              **GREEDY)
    want, want_mask = jiface.vamp(jnp.asarray(jz), jnp.asarray(mask), **kw)
    got, got_mask = tiface.vamp(tz, mask, **kw)
    assert got.shape == (2, 4, 300) and isinstance(got_mask, np.ndarray)
    np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got == tiface.coarse.mask_token).any()


def test_long_chunk_matches_jax_auto(monkeypatch):
    """A 5 s coarse chunk at the tiny 8 kHz codec is 1,250 tokens: past 1024,
    where the port's attention takes its long route (K9) and JAX's "auto"
    takes XLA on the CPU. The port's coarse LM runs the kernels' route
    ("pallas", on the CPU their plain versions). Its c2f LM stays on "auto":
    on the 250-token c2f chunks the kernels' base-2 arithmetic and XLA's
    differ by rounding, which flips a few greedy near-ties (6 of 5,000
    tokens at this seed)."""
    jiface, tiface = _pair(sample_rate=8000, coarse_chunk_s=1.0, c2f_chunk_s=1.0,
                           coarse_impl="pallas")
    for iface in (jiface, tiface):
        iface.set_chunk_size(5)
    assert tiface.s2t(5) == 1250
    jz, tz = _codes(jiface, tiface, seconds=5.0, sr=8000)
    assert jz.shape[-1] == 1250
    long_calls = []
    real = fa.attention_fwd_long
    monkeypatch.setattr(fa, "attention_fwd_long",
                        lambda *a: long_calls.append(a[0].shape) or real(*a))
    mask = _prompt_mask(jz.shape, 25, upper=3)
    kw = dict(batch_size=1, seed=2, _sampling_steps=2, **GREEDY)
    want = np.asarray(jiface.vamp(jnp.asarray(jz), jnp.asarray(mask), **kw))
    got = tiface.vamp(tz, mask, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # 2 coarse steps x 2 layers through the long route, at t = 1250
    assert long_calls == [(1, 1250, 4, 16)] * 4


def test_set_chunk_size_reaches_vamp_e2e_and_survives_quantize(monkeypatch):
    _, tiface = _pair(coarse_chunk_s=0.1)
    seen = []
    real = Interface._run_generate

    def spy(self, lm, start_tokens, *a, **kw):
        seen.append((lm is self.coarse, tuple(start_tokens.shape)))
        return real(self, lm, start_tokens, *a, **kw)

    monkeypatch.setattr(Interface, "_run_generate", spy)
    samples, sr = _signal(0.3, 16000)
    tiface.set_chunk_size(0.06)  # 30 tokens: 150 tokens are 5 chunks
    tiface.vamp_e2e(AudioSignal(samples, sr), batch_size=2, seed=0, _sampling_steps=2)
    # coarse: 5 chunks x 2 rows of 30; c2f: 6 chunks of 25 (0.05 s)
    assert seen == [(True, (10, 2, 30)), (False, (12, 4, 25))]
    tiface.quantize()
    assert tiface.coarse.chunk_size_s == 0.06 and tiface.c2f.chunk_size_s == 0.05
    assert tiface.t2s(30) == 0.06 and tiface.s2t2s(0.059) == 0.06


def test_coarse_vamp_takes_a_gen_fn(interfaces):
    _, tiface = interfaces
    z = torch.randint(0, 64, (2, 4, 40))
    mask = torch.from_numpy(_prompt_mask((2, 4, 40), 3))
    seen = {}

    def gen_fn(start_tokens, mask, generator, **kwargs):
        seen.update(shape=tuple(start_tokens.shape), kwargs=kwargs,
                    generator=isinstance(generator, torch.Generator))
        return torch.where(start_tokens == tiface.coarse.mask_token, 0, start_tokens)

    out, masked = tiface.coarse_vamp(z, mask, return_mask=True, gen_fn=gen_fn, seed=0,
                                     temperature=0.5)
    # 40 tokens in one 75-token chunk per batch row; the fine codebooks from z
    assert seen == dict(shape=(2, 2, 75), kwargs=dict(temperature=0.5), generator=True)
    np.testing.assert_array_equal(out[:, 2:].numpy(), z[:, 2:].numpy())
    kept = mask[:, :2] == 0
    assert torch.equal(out[:, :2][kept], z[:, :2][kept]) and not out[:, :2][~kept].any()
    assert torch.equal(masked[:, :2][kept], z[:, :2][kept])


def test_unported_options_raise(interfaces):
    _, tiface = interfaces
    z = torch.zeros((1, 4, 30), dtype=torch.int64)
    m = torch.ones_like(z)
    # top_k, cfg_guidance and the onset mask are ported (tests/test_torch_guidance.py,
    # tests/test_torch_masks.py); the chunk-free path and per-row mask seeds are not
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tiface.coarse_vamp(z, m, chunked=False)
    with pytest.raises(NotImplementedError, match="per-row"):
        tiface.build_mask(z, seed=[1, 2])
    with pytest.raises(TypeError):
        tiface.vamp(z, m, no_such_option=1)
