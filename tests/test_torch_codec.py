"""Port parity: the codec (`codec/`) and the host audio path (`audio/`),
against the JAX codec on one numpy param tree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import codec_params_np, configs, to_jax
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.codec import LAC
from vampnet_tpu_torch.convert import codec_state_dict_from_jax


@pytest.fixture(scope="module")
def codecs():
    jcfg, tcfg, _ = configs()
    params = codec_params_np(jcfg, 0)
    codec = LAC(tcfg, device="cpu")
    codec.load_state_dict(codec_state_dict_from_jax(params, tcfg), strict=True)
    return JLAC(jcfg), to_jax(params), codec.requires_grad_(False)


def _audio(b=2, n=3200, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = np.stack([0.5 * np.sin(2 * np.pi * f * t) for f in (220.0, 347.0)[:b]])
    return (x + 0.05 * rng.standard_normal((b, n)))[:, :, None].astype(np.float32)


def test_codec_state_dict_covers_every_param():
    jcfg, tcfg, _ = configs()
    sd = codec_state_dict_from_jax(codec_params_np(jcfg, 1), tcfg)
    model_sd = LAC(tcfg, device="meta").state_dict()
    assert set(sd) == set(model_sd)
    assert all(tuple(sd[k].shape) == tuple(model_sd[k].shape) for k in sd)


def test_codes_identical_and_waveform_close(codecs):
    jlac, jparams, codec = codecs
    audio = _audio()
    want = np.asarray(jlac.apply({"params": jparams}, jnp.asarray(audio), method="encode")["codes"])
    got = codec.encode(torch.from_numpy(audio))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8  # the codes are not degenerate

    want_wav = np.asarray(jlac.apply({"params": jparams}, jnp.asarray(want), method="decode_codes"))
    got_wav = codec.decode_codes(torch.from_numpy(np.array(want))).numpy()
    assert got_wav.shape == want_wav.shape == audio.shape
    # fp32 convolutions, 3 decoder blocks: summation order only
    np.testing.assert_allclose(got_wav, want_wav, rtol=1e-4, atol=1e-5)


def test_codebook_tables_identical(codecs):
    jlac, jparams, codec = codecs
    want = np.asarray(jlac.apply({"params": jparams}, method="codebook_tables"))
    np.testing.assert_array_equal(codec.codebook_tables().numpy(), want)


def test_preprocess_chain_matches_jax():
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((1, 2, 11025))).astype(np.float32)
    mine = AudioSignal(x, 22050).resample(16000).to_mono().normalize(-24.0).ensure_max_of_audio(1.0)
    ref = JAudioSignal(x, 22050).resample(16000).to_mono().normalize(-24.0).ensure_max_of_audio(1.0)
    np.testing.assert_array_equal(mine.samples, ref.samples)
    np.testing.assert_array_equal(mine.loudness(), ref.loudness())
    mine.zero_pad(0, 7)
    assert mine.length == ref.length + 7 and mine.sample_rate == 16000
