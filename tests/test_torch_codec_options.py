"""Port parity: the codec's compute options (`codec/layers.py`,
`codec/model.py`) against the JAX package's: the matmul conv schedules at
every (k, s, p, d) the codec uses, the full codec with `conv_impl="matmul"`,
`compute_dtype="bfloat16"` and `decoder_compute_dtype="bfloat16"`,
`from_latents`, `decode_latents`, `encode(n_quantizers=)`, and
`Interface.from_checkpoints(codec_overrides=)` against the JAX `Interface`.

Inputs come from numpy seeds; the codec is the tiny one of
`test_torch_util` on one numpy param tree. Each tolerance is stated where it
is asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec import _audio
from test_torch_util import codec_params_np, configs, to_jax
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.codec.layers import WNConv1d as JWNConv1d
from vampnet_tpu.codec.layers import WNConvTranspose1d as JWNConvTranspose1d
from vampnet_tpu_torch.codec import LAC
from vampnet_tpu_torch.codec.layers import WNConv1d, WNConvTranspose1d
from vampnet_tpu_torch.convert import codec_state_dict_from_jax

# every conv of the codec: the residual units' k7 at dilations 1, 3, 9, the
# k1 projections, conv_in/conv_out (k7 p3, k3 p1) and the k = 2s
# downsamplers at strides 2, 4, 8; channels narrow (< 128) and wide
CONVS = [(7, 1, 3, 1), (7, 1, 9, 3), (7, 1, 27, 9), (1, 1, 0, 1), (3, 1, 1, 1),
         (4, 2, 1, 1), (8, 4, 2, 1), (16, 8, 4, 1)]
CONV_TS = [(4, 2, 1), (8, 4, 2), (16, 8, 4)]  # the decoder's upsamplers


def _conv_params(rng, shape_v, n_g, c_out):
    return dict(v=rng.standard_normal(shape_v).astype(np.float32),
                g=rng.uniform(0.5, 1.5, n_g).astype(np.float32),
                bias=(0.1 * rng.standard_normal(c_out)).astype(np.float32))


def _load(layer, params):
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
    return layer.requires_grad_(False)


@pytest.mark.parametrize("c_in,c_out", [(5, 6), (160, 24)], ids=["narrow", "wide"])
@pytest.mark.parametrize("k,s,p,d", CONVS)
def test_wnconv1d_matmul_matches_jax(k, s, p, d, c_in, c_out):
    rng = np.random.default_rng(k * 100 + s * 10 + d)
    t = 64
    params = _conv_params(rng, (c_out, c_in, k), c_out, c_out)
    x = rng.standard_normal((2, t, c_in)).astype(np.float32)
    want = np.asarray(JWNConv1d(c_out, kernel_size=k, stride=s, padding=p, dilation=d,
                                impl="matmul").apply({"params": to_jax(params)}, jnp.asarray(x)))
    outs = {}
    for impl in ("matmul", "xla"):
        layer = _load(WNConv1d(c_in, c_out, k, stride=s, padding=p, dilation=d, impl=impl,
                               device="cpu"), params)
        outs[impl] = layer(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert outs["matmul"].shape == want.shape
    # fp32 products of depth <= k * c_in in other summation orders
    np.testing.assert_allclose(outs["matmul"], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs["matmul"], outs["xla"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,s,p", CONV_TS)
def test_wnconvtranspose1d_matmul_matches_jax(k, s, p):
    rng = np.random.default_rng(k)
    c_in, c_out, t = 12, 7, 20
    params = _conv_params(rng, (c_in, c_out, k), c_in, c_out)
    x = rng.standard_normal((2, t, c_in)).astype(np.float32)
    want = np.asarray(JWNConvTranspose1d(c_out, kernel_size=k, stride=s, padding=p,
                                         impl="matmul").apply({"params": to_jax(params)},
                                                              jnp.asarray(x)))
    assert want.shape[1] == (t - 1) * s - 2 * p + k
    outs = {}
    for impl in ("matmul", "xla"):
        layer = _load(WNConvTranspose1d(c_in, c_out, k, stride=s, padding=p, impl=impl,
                                        device="cpu"), params)
        outs[impl] = layer(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    # fp32 products of depth c_in, then one add per output
    np.testing.assert_allclose(outs["matmul"], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs["matmul"], outs["xla"], rtol=1e-4, atol=1e-5)


def test_matmul_schedules_refuse_what_they_do_not_cover():
    with pytest.raises(ValueError, match="impl"):
        WNConv1d(3, 4, 3, impl="cudnn", device="meta")
    from vampnet_tpu_torch.codec.layers import conv1d_matmul, conv_transpose1d_matmul

    with pytest.raises(ValueError, match="k = 2 stride"):
        conv1d_matmul(torch.zeros(1, 2, 16), torch.zeros(3, 2, 5), 2, 0, 1)
    with pytest.raises(ValueError, match="k = 2 stride"):
        conv_transpose1d_matmul(torch.zeros(1, 2, 16), torch.zeros(2, 3, 5), 2, 0)


def _codecs(**opts):
    jcfg, tcfg, _ = configs()
    jcfg, tcfg = dataclasses.replace(jcfg, **opts), dataclasses.replace(tcfg, **opts)
    params = codec_params_np(jcfg, 0)
    codec = LAC(tcfg, device="cpu")
    codec.load_state_dict(codec_state_dict_from_jax(params, tcfg), strict=True)
    return JLAC(jcfg), to_jax(params), codec.requires_grad_(False)


def _jax_encode(jlac, jparams, audio, n_q=None):
    args = (jnp.asarray(audio),) if n_q is None else (jnp.asarray(audio), n_q)
    return np.asarray(jlac.apply({"params": jparams}, *args, method="encode")["codes"])


def _jax_decode(jlac, jparams, codes):
    return np.asarray(jlac.apply({"params": jparams}, jnp.asarray(codes), method="decode_codes"))


def _jax_latents(jlac, jparams, audio):
    """The encoder's output (b, t / hop, latent_dim), before the RVQ."""
    return np.asarray(jlac.apply({"params": jparams}, jnp.asarray(audio),
                                 method=lambda m, x: m.encoder(x)))


def _latents(codec, audio):
    with torch.no_grad():
        return codec.encoder(torch.from_numpy(audio).transpose(1, 2)).transpose(1, 2).numpy()


def test_matmul_codec_codes_identical_to_jax():
    jlac, jparams, codec = _codecs(conv_impl="matmul")
    audio = _audio()
    want = _jax_encode(jlac, jparams, audio)
    got = codec.encode(torch.from_numpy(audio))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8  # the codes are not degenerate
    # and the same codes as the default schedule
    _, _, xla_codec = _codecs()
    np.testing.assert_array_equal(xla_codec.encode(torch.from_numpy(audio)).numpy(), want)
    got_wav = codec.decode_codes(torch.from_numpy(want)).numpy()
    # fp32, 3 decoder blocks, matmuls in other summation orders
    np.testing.assert_allclose(got_wav, _jax_decode(jlac, jparams, want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("opts", [dict(compute_dtype="bfloat16"),
                                  dict(compute_dtype="bfloat16", conv_impl="matmul"),
                                  dict(decoder_compute_dtype="bfloat16"),
                                  dict(decoder_compute_dtype="bfloat16", conv_impl="matmul")],
                         ids=["bf16", "bf16-matmul", "decoder-bf16", "decoder-bf16-matmul"])
def test_bf16_options_match_jax_bf16(opts):
    jlac, jparams, codec = _codecs(**opts)
    audio = _audio()
    want = _jax_encode(jlac, jparams, audio)
    got = codec.encode(torch.from_numpy(audio)).numpy()
    if "compute_dtype" in opts:
        # bf16 convolutions round differently in the two libraries; a code
        # flips only where two codebook entries are nearly tied
        assert (got != want).mean() <= 0.05, (got != want).mean()
    else:
        # the decoder's dtype leaves the fp32 encoder, and so the codes, alone
        np.testing.assert_array_equal(got, want)
    wav = codec.decode_codes(torch.from_numpy(want)).numpy()
    jwav = _jax_decode(jlac, jparams, want)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
    # bf16 activations through the decoder's blocks on both sides: within a
    # few bf16 ulps of each other, relative to the waveform
    rel = np.linalg.norm(wav - jwav) / np.linalg.norm(jwav)
    assert rel <= 0.05, rel
    jlac32, _, f32 = _codecs()
    ref = f32.decode_codes(torch.from_numpy(want)).numpy()
    assert np.linalg.norm(wav - ref) / np.linalg.norm(ref) <= 0.05
    # The option is computed in bf16 as JAX computes it: the port's bf16
    # output sits as far from its own fp32 output as JAX's bf16 sits from
    # JAX's fp32 (readings on the CPU: encoder latents 0.0068-0.0077 against
    # 0.0074-0.0077, audio 0.0086-0.0100 against 0.0092-0.0101). A port that
    # ignored the dtype reads 0 or about 5e-7 there, one in fp16 about 8x
    # less than JAX's, so either fails the factor of 2 asserted here; the
    # closeness to JAX bf16 above does not tell fp32 apart (fp32 against
    # JAX bf16 reads the same 0.009)
    def gap(x, ref):
        return np.linalg.norm(x - ref) / np.linalg.norm(ref)

    jwav32 = _jax_decode(jlac32, jparams, want)
    jlat, jlat32 = (_jax_latents(j, jparams, audio) for j in (jlac, jlac32))
    lat, lat32 = (_latents(c, audio) for c in (codec, f32))
    pairs = [("audio", gap(wav, ref), gap(jwav, jwav32))]
    if "compute_dtype" in opts:
        pairs.append(("latents", gap(lat, lat32), gap(jlat, jlat32)))
    else:
        # the encoder stays fp32 (summation order aside)
        assert gap(lat, lat32) <= 1e-5 and gap(jlat, jlat32) <= 1e-5
    for name, port_gap, jax_gap in pairs:
        assert 0.5 * jax_gap <= port_gap <= 2.0 * jax_gap, (name, port_gap, jax_gap)


def test_from_latents_decode_latents_and_n_quantizers_match_jax():
    jlac, jparams, codec = _codecs()
    audio = _audio()
    codes = _jax_encode(jlac, jparams, audio)
    tables = np.asarray(jlac.apply({"params": jparams}, method="codebook_tables"))
    b, n_cb, t = codes.shape
    lat = tables[np.arange(n_cb)[None, :, None], codes]  # (b, n_cb, t, d)
    lat = np.ascontiguousarray(lat.transpose(0, 2, 1, 3).reshape(b, t, -1))
    want_zq = np.asarray(jlac.apply({"params": jparams}, jnp.asarray(lat),
                                    method=lambda m, x: m.quantizer.from_latents(x)))
    got_zq = codec.quantizer.from_latents(torch.from_numpy(lat)).transpose(1, 2).numpy()
    # fp32 k = 1 projections, summed over 4 stages
    np.testing.assert_allclose(got_zq, want_zq, rtol=1e-5, atol=1e-5)
    want = np.asarray(jlac.apply({"params": jparams}, jnp.asarray(lat), method="decode_latents"))
    got = codec.decode_latents(torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # decoding the codes' latents is decoding the codes
    np.testing.assert_allclose(got, codec.decode_codes(torch.from_numpy(codes)).numpy(),
                               atol=1e-5)
    # nearest entries of one stage, by cosine similarity
    rng = np.random.default_rng(4)
    z_e = rng.standard_normal((2, 9, tables.shape[-1])).astype(np.float32)
    jz, jidx = jlac.apply({"params": jparams}, jnp.asarray(z_e),
                          method=lambda m, x: m.quantizer.quantizers[1].decode_latents(x))
    tz, tidx = codec.quantizer.quantizer(1).decode_latents(torch.from_numpy(z_e))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    for n_q in (1, 2, 3):
        got = codec.encode(torch.from_numpy(audio), n_quantizers=n_q).numpy()
        np.testing.assert_array_equal(got, _jax_encode(jlac, jparams, audio, n_q))
        np.testing.assert_array_equal(got, codes[:, :n_q])


def test_no_tf32_restores_the_flags_after_overlapping_callers():
    from vampnet_tpu_torch.codec.layers import no_tf32

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        outer = no_tf32()
        outer.__enter__()
        inner = no_tf32()
        inner.__enter__()
        assert not torch.backends.cuda.matmul.allow_tf32
        outer.__exit__(None, None, None)  # the first caller leaves first
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        inner.__exit__(None, None, None)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("overrides", [dict(conv_impl="matmul"),
                                       dict(decoder_compute_dtype="bfloat16",
                                            conv_impl="matmul")],
                         ids=["matmul", "decoder-bf16-matmul"])
def test_interface_codec_overrides_match_jax_interface(tmp_path, overrides):
    from vampnet_tpu import checkpoints as jckpt
    from vampnet_tpu.interface import Interface as JInterface
    from vampnet_tpu_torch.interface import Interface

    jc, tc, lms = configs()
    jckpt.save_codec(tmp_path / "codec.vtpu", jc, codec_params_np(jc, 5))
    from test_torch_util import lm_params_np

    jckpt.save_lm(tmp_path / "coarse.vtpu", lms["coarse"][0], lm_params_np(lms["coarse"][0], 6))
    files = dict(coarse_ckpt=str(tmp_path / "coarse.vtpu"), codec_ckpt=str(tmp_path / "codec.vtpu"))
    jiface = JInterface(**files, codec_overrides=overrides)
    iface = Interface.from_checkpoints(**files, codec_overrides=overrides, device="cpu")
    assert iface.codec_config == tc.__class__(**dataclasses.asdict(jiface.codec_config))
    for k, v in overrides.items():
        assert getattr(iface.codec_config, k) == v
    audio = _audio()
    want = np.asarray(jiface.codec_model.apply({"params": jiface.codec_params}, jnp.asarray(audio),
                                         method="encode")["codes"])
    got = iface.codec.encode(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(got, want)
    jwav = np.asarray(jiface.codec_model.apply({"params": jiface.codec_params}, jnp.asarray(want),
                                         method="decode_codes"))
    wav = iface.codec.decode_codes(torch.from_numpy(want)).numpy()
    # fp32 decoder: summation order; a bf16 decoder: bf16 rounding on both sides
    tol = 1e-4 if "decoder_compute_dtype" not in overrides else 0.05
    assert np.linalg.norm(wav - jwav) / np.linalg.norm(jwav) <= tol
