"""Port: MAGNeT text-to-music (`vampnet_tpu_torch/magnet.py`,
`modules/magnet.py`, `codec/encodec.py`, `sampling/generate.py`'s
`magnet_generate`, the engine's `MagnetRequest`) against the plain fp32
reference `tests/plain_magnet.py`, at tiny widths on the CPU, with the
published structure: the T5 encoder with its shared relative bias and
padded text, the LM at stage 0 (full attention) and at a banded stage with
an all-zero CFG row, the EnCodec decoder, a whole stage loop under the same
draws, the engine's groups against the same requests served alone, the
sampler's plain version at V = 2,048, the attention's plain routes with a
window, with no bias and with t_k != t_q, and the new spans.

Everything computes in fp32 on both sides, so the port meets the
reference to rounding (a few ulps of its largest value), and sampled
tokens and chosen spans are equal.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import plain_magnet as pm
import test_torch_util  # noqa: F401  (the worker's thread share)
from vampnet_tpu_torch import profiling
from vampnet_tpu_torch.codec.encodec import EncodecConfig, EncodecDecoder
from vampnet_tpu_torch.magnet import MagnetInterface, text_batch
from vampnet_tpu_torch.modules.magnet import MagnetConfig, MagnetLM, T5Config, T5Encoder
from vampnet_tpu_torch.modules.transformer import relative_position_bucket
from vampnet_tpu_torch.ops import flash_attention as fa
from vampnet_tpu_torch.ops.attention import attention_plain, dot_product_attention
from vampnet_tpu_torch.ops.relative_bias import RelativePositionBias
from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits
from vampnet_tpu_torch.sampling.generate import magnet_generate
from vampnet_tpu_torch.serve import MagnetRequest, VampEngine

T5C = T5Config(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_kv=16, d_ff=64, out_dim=48,
               compute_dtype="float32")
LMC = MagnetConfig(dim=48, n_layers=2, n_heads=3, ffn_dim=96, n_q=4, card=32, subcodes_context=2,
                   compute_dtype="float32")
CC = EncodecConfig(sample_rate=200, dimension=8, n_filters=4, ratios=(2, 2), n_q=4, bins=32)
GEN = dict(decoding_steps=(4, 2, 2, 2))
TEXT_BUCKET = 8
T = 12  # frames: 0.24 s at 50 frames a second, 4 spans of 3
TEXTS = [[5, 7, 9], [1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5, 4, 3, 2]]


def _init(module: torch.nn.Module, seed: int) -> dict:
    """Seeded weights that keep activations O(1): 2-D weights normal /
    sqrt(fan-in), norm scales 1 + 0.1 normal, biases 0.02 normal, weight-norm
    gains 0.8-1.2, LSTM weights normal / 2 sqrt(hidden)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        x = torch.randn(v.shape, generator=g)
        if k.endswith(".g"):
            x = 0.8 + 0.4 * torch.rand(v.shape, generator=g)
        elif ".lstm." in k:
            x = 0.5 * x / v.shape[-1] ** 0.5
        elif k.endswith(".weight") and x.dim() == 2:
            x = x / x.shape[1] ** 0.5
        elif k.endswith(".weight"):
            x = 1.0 + 0.1 * x
        elif k.endswith("bias"):
            x = 0.02 * x
        sd[k] = x
    return sd


def _plain_cfg(plain: dict, cfg) -> dict:
    return {k: getattr(cfg, k) for k in plain}


@pytest.fixture(scope="module")
def m():
    t5 = _init(T5Encoder(T5C), 1)
    lm = _init(MagnetLM(LMC), 2)
    codec = _init(EncodecDecoder(CC), 3)
    iface = MagnetInterface.from_modules(T5C, t5, LMC, lm, CC, codec, text_bucket=TEXT_BUCKET,
                                         device="cpu")
    return dict(iface=iface, t5=t5, lm=lm, codec=codec, T5=_plain_cfg(pm.T5, T5C),
                LM=_plain_cfg(pm.LM, LMC), CODEC=_plain_cfg(pm.CODEC, CC))


def _close(got, want, ulps=64):
    """Equal to rounding: within `ulps` fp32 ulps of the reference's largest
    magnitude (sums taken in another order)."""
    tol = ulps * torch.finfo(torch.float32).eps * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


def test_t5_output_with_padded_text_matches_plain(m):
    ids, mask = text_batch(TEXTS, TEXT_BUCKET)
    c = m["iface"].encode_text(ids, mask)
    for i, text in enumerate(TEXTS):
        want = pm.t5_encode(m["t5"], m["T5"], text, TEXT_BUCKET)
        _close(c[i], want)
        assert not c[i, len(text):].any()  # padding zeroed after output_proj


def test_t5_bias_is_relative_position_bias_at_the_same_table(m):
    enc = m["iface"].t5
    l = 11
    got = enc.position_bias(l)
    offsets = relative_position_bucket(torch.arange(-(l - 1), l), num_buckets=32,
                                       max_distance=128)
    want = RelativePositionBias.apply(enc.rel_bias.weight, offsets, l, l)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    pos = torch.arange(l)
    plain = m["t5"]["rel_bias.weight"][pm.t5_bucket(pos[None] - pos[:, None], 32, 128)]
    torch.testing.assert_close(got, plain.permute(2, 0, 1), rtol=0, atol=0)


@pytest.mark.parametrize("stage", [0, 2])
def test_lm_logits_match_plain_with_padded_text_and_a_zero_cfg_row(m, stage):
    """Stage 0 attends everywhere, stage 2 within |i - j| <= 2: the second
    half of the rows is the all-zero CFG conditioning."""
    iface = m["iface"]
    ids, mask = text_batch(TEXTS[:2], TEXT_BUCKET)
    c = iface.encode_text(ids, mask)
    c2 = torch.cat([c, torch.zeros_like(c)])
    g = torch.Generator().manual_seed(stage)
    codes = torch.randint(0, LMC.card + 1, (4, LMC.n_q, T), generator=g)
    got = iface.lm(codes, stage, iface.lm.cross_kv(c2))
    for i in range(4):
        want = pm.lm_logits(m["lm"], m["LM"], codes[i], stage, c2[i])
        _close(got[i], want)
    if stage:  # the band decides the result: without it the logits move
        unbanded = dict(m["LM"], subcodes_context=T)
        far = pm.lm_logits(m["lm"], unbanded, codes[0], stage, c2[0])
        assert float((far - got[0]).abs().max()) > 1e-3


def test_encodec_decode_matches_plain(m):
    g = torch.Generator().manual_seed(4)
    codes = torch.randint(0, CC.bins, (2, CC.n_q, T), generator=g)
    audio = m["iface"].decode(codes)
    assert audio.shape == (2, 1, T * CC.hop_length)
    for i in range(2):
        _close(audio[i, 0], pm.decode(m["codec"], m["CODEC"], codes[i]))


def _plain_loop(m, text, seed):
    c = pm.t5_encode(m["t5"], m["T5"], text, TEXT_BUCKET)

    def logits(codes, stage, cond):
        return pm.lm_logits(m["lm"], m["LM"], codes, stage, c if cond else torch.zeros_like(c))

    return pm.stage_loop(logits, seed, LMC.n_q, T, LMC.card, GEN)


def test_stage_loop_tokens_and_remasking_match_plain_under_the_same_draws(m):
    iface = m["iface"]
    ids, mask = text_batch(TEXTS[:2], TEXT_BUCKET)
    c = iface.encode_text(ids, mask)
    kv = iface.lm.cross_kv(torch.cat([c, torch.zeros_like(c)]))
    inputs = []

    def forward(codes, stage):
        inputs.append((stage, codes[:2].clone()))
        return iface.lm(codes, stage, kv)

    seeds = [11, 12]
    keys = torch.tensor([[0, s] for s in seeds])
    codes = magnet_generate(forward, 2, LMC.n_q, T, LMC.mask_id, keys, **GEN)
    assert len(inputs) == sum(GEN["decoding_steps"])
    for row, (text, seed) in enumerate(zip(TEXTS, seeds)):
        want, chosen = _plain_loop(m, text, seed)
        torch.testing.assert_close(codes[row], want, rtol=0, atol=0)
        for (stage, x), ch in zip(inputs, chosen):
            masked = x[row, stage] == LMC.mask_id  # the spans the step re-masked
            torch.testing.assert_close(masked, ch.repeat_interleave(3), rtol=0, atol=0)
            assert (x[row, stage + 1:] == LMC.mask_id).all()  # later codebooks wait


def test_engine_group_rows_equal_requests_served_alone(m):
    iface = m["iface"]
    reqs = [MagnetRequest(text_ids=np.array(t), seconds=0.24, seed=100 + i, top_p=0.9,
                          decoding_steps=GEN["decoding_steps"]) for i, t in enumerate(TEXTS)]
    reqs[1].temperature, reqs[2].max_cfg_coef = 2.0, 4.0  # per-row knobs share the group
    engine = VampEngine(None, max_batch=4, max_wait_ms=200, magnet=iface)
    try:
        alone = [engine.submit(r).result(timeout=120) for r in reqs]
        before = dict(engine.stats)
        futs = [engine.submit(r) for r in reqs]
        together = [f.result(timeout=120) for f in futs]
        assert engine.stats["batches"] - before["batches"] == 1
        assert engine.stats["magnet_rows"] - before["magnet_rows"] == 3
        assert engine.stats["cfg_rows"] - before["cfg_rows"] == 3
    finally:
        engine.close()
    for (ca, aa), (cb, ab) in zip(alone, together):
        assert ca.shape == (1, LMC.n_q, T) and aa.shape == (1, 1, T * CC.hop_length)
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_allclose(aa, ab, rtol=0, atol=1e-5)
    # and the plain loop's tokens for the first request
    want, _ = _plain_loop(m, TEXTS[0], 100)
    np.testing.assert_array_equal(alone[0][0][0], want.numpy())


def test_sampler_plain_path_at_vocab_2048_matches_plain_magnet():
    """K10's plain version at V = 2,048: its Philox counters run to V / 4 =
    512 words; tokens equal plain_magnet's Gumbel-max over the top-p set,
    and probabilities are the kept set's."""
    g = torch.Generator().manual_seed(5)
    b, t, v = 2, 40, 2048
    logits = 3.0 * torch.randn((b, t, v), generator=g)
    seeds = [7, 2 ** 31 + 5]
    keys = torch.tensor([[0, s & 0xFFFFFFFF] for s in seeds])
    ones = torch.ones(b)
    for step, top_p in ((0, 0.9), (17, 0.5)):
        tokens, probs = fused_sample_from_logits(
            keys, step, logits, ones, ones, top_p=torch.full((b,), top_p),
            typical_filtering=False, use_top_p=True)
        for r in range(b):
            want_t, want_p = pm.sample(logits[r], pm.gumbel(seeds[r], step, t, v, "cpu"), top_p)
            torch.testing.assert_close(tokens[r], want_t, rtol=0, atol=0)
            torch.testing.assert_close(probs[r], want_p, rtol=1e-5, atol=1e-7)


def _qkv(t_q=37, t_k=None, b=2, h=3, d=16, seed=6):
    g = torch.Generator().manual_seed(seed)
    t_k = t_q if t_k is None else t_k
    return (torch.randn((b, t_q, h, d), generator=g), torch.randn((b, t_k, h, d), generator=g),
            torch.randn((b, t_k, h, d), generator=g))


@pytest.mark.parametrize("case", ["window", "no_bias", "cross"])
def test_attention_plain_routes_match_attention_plain(case):
    """The kernels' plain version (base-2 softmax with the prefolds) and the
    route `dot_product_attention(impl="pallas")` takes on the CPU, against
    `attention_plain` (the window as a (b, t, t) mask there)."""
    q, k, v = _qkv(t_k=9 if case == "cross" else None)
    window = 4 if case == "window" else None
    mask = None
    if window is not None:
        mask = fa.band(q.shape[1], k.shape[1], window, q.device)[None].expand(q.shape[0], -1, -1)
    want = attention_plain(q, k, v, mask=mask)
    for got in (fa.attention_fwd_plain(q, k, v, window=window),
                dot_product_attention(q, k, v, impl="pallas", window=window),
                dot_product_attention(q, k, v, window=window)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if window is not None:  # the window decides the result
        assert float((fa.attention_fwd_plain(q, k, v) - want).abs().max()) > 1e-2


def test_attention_refuses_a_window_with_a_bias_or_a_grad():
    q, k, v = _qkv()
    bias = torch.zeros((3, 37, 37))
    with pytest.raises(ValueError):
        fa.flash_attention_with_bias(q, k, v, bias, torch.ones((2, 37, 37)), window=2)
    with pytest.raises(ValueError):
        fa.flash_attention_with_bias(q.requires_grad_(), k, v, window=2)


def test_spans_recorded_per_group(m):
    iface = m["iface"]
    engine = VampEngine(None, max_batch=4, max_wait_ms=200, magnet=iface)
    profiling.clear()
    profiling.enable()
    try:
        futs = [engine.submit(MagnetRequest(text_ids=np.array(t), seconds=0.24, seed=i,
                                            decoding_steps=GEN["decoding_steps"]))
                for i, t in enumerate(TEXTS[:2])]
        for f in futs:
            f.result(timeout=120)
    finally:
        profiling.disable()
        engine.close()
    recs = profiling.records()
    profiling.clear()
    names = [r.name for r in recs]
    assert names.count("magnet.t5") == 1 and names.count("encodec.decode") == 1
    stages = [r.ids for r in recs if r.name == "magnet.stage"]
    assert stages == [dict(stage=s, steps=n, rows=4)
                      for s, n in enumerate(GEN["decoding_steps"])]
    dispatch = [r for r in recs if r.name == "engine.dispatch"]
    assert len(dispatch) == 1 and dispatch[0].ids["rows"] == 2
    t5 = [r for r in recs if r.name == "magnet.t5"][0]
    assert t5.ids == dict(rows=2, tokens=TEXT_BUCKET) and t5.parent == dispatch[0].id


def test_frames_and_text_grid():
    assert math.ceil(30 * 32000 / EncodecConfig().hop_length) == 1500
    iface = MagnetInterface.__new__(MagnetInterface)
    iface.text_bucket = 64
    assert [iface.text_len(n) for n in (1, 8, 64, 65)] == [64, 64, 64, 128]
