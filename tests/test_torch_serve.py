"""Port: the serving stack (`vampnet_tpu_torch/serve/`), each test of
`tests/test_serve.py` against the port, plus the port held against the JAX
package where both can see the same inputs:

  * the engine's tokens equal the JAX engine's at the settings in which no
    random draw decides a token (greedy, `mask_temperature=0`, a prompt in
    every chunk), on one numpy param tree at fp32;
  * OSC messages are byte for byte the JAX package's;
  * `vamp_core` makes the JAX `vamp_core`'s calls on a recording interface,
    and its loudness normalisation and pitch shift give the JAX waveforms;
  * the token telephone's state machine moves as the JAX one on the same
    numpy blocks.

The configs are `tests/test_serve.py`'s. Nothing here reaches a network:
`huggingface_hub` is replaced by a fake that fails as an offline hub does,
and the models directory is empty. Every wait is bounded (60 s).
"""
import base64
import dataclasses
import http.client
import json
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_serve import C2F_CFG, CODEC_CFG, COARSE_CFG
from test_torch_util import codec_params_np, lm_params_np, to_jax
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu.audio.dsp import pitch_shift as jpitch_shift
from vampnet_tpu.interface import Interface as JInterface
from vampnet_tpu.serve import VampEngine as JVampEngine
from vampnet_tpu.serve import VampRequest as JVampRequest
from vampnet_tpu.serve import app as japp
from vampnet_tpu.serve import osc as josc
from vampnet_tpu.serve import token_telephone as jtt
from vampnet_tpu_torch import convert, profiling, registry
from vampnet_tpu_torch.audio import AudioSignal, signal_concat
from vampnet_tpu_torch.audio.dsp import pitch_shift
from vampnet_tpu_torch.codec import CodecConfig
from vampnet_tpu_torch.interface import Interface
from vampnet_tpu_torch.modules import LMConfig
from vampnet_tpu_torch.serve import VampEngine, VampRequest, app, make_server
from vampnet_tpu_torch.serve import token_telephone as tt
from vampnet_tpu_torch.serve.osc import (
    Dispatcher,
    OSCClient,
    OSCServer,
    decode_message,
    encode_message,
)
from vampnet_tpu_torch.serve.webapp import audio_to_wav_bytes, wav_bytes_to_audio

WAIT = 60  # seconds: every future, socket and join


def _port_cfg(cls, jcfg, **kw):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)}, **kw)


@pytest.fixture(scope="module", autouse=True)
def offline_hub(tmp_path_factory):
    """A `huggingface_hub` that fails as an offline hub does, and an empty
    models directory, for every test here."""
    hub = types.ModuleType("huggingface_hub")

    def offline(*a, **kw):
        raise OSError("offline")

    hub.hf_hub_download = offline
    hub.HfFileSystem = offline
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "huggingface_hub", hub)
        mp.setattr(registry, "MODELS_DIR", tmp_path_factory.mktemp("models"))
        yield


@pytest.fixture(scope="module")
def ifaces():
    """(JAX Interface, port Interface on the CPU) from one numpy param tree,
    both at fp32 compute, with `tests/test_serve.py`'s configs and chunks."""
    coarse_j = dataclasses.replace(COARSE_CFG, compute_dtype="float32")
    c2f_j = dataclasses.replace(C2F_CFG, compute_dtype="float32")
    codec_np = codec_params_np(CODEC_CFG, 70)
    coarse_np, c2f_np = lm_params_np(coarse_j, 71), lm_params_np(c2f_j, 72)
    chunks = dict(coarse_chunk_size_s=0.2, coarse2fine_chunk_size_s=0.1)
    jiface = JInterface.from_modules(CODEC_CFG, to_jax(codec_np), coarse_j, to_jax(coarse_np),
                                     c2f_j, to_jax(c2f_np), **chunks)
    tc = _port_cfg(CodecConfig, CODEC_CFG)
    coarse_t, c2f_t = _port_cfg(LMConfig, coarse_j), _port_cfg(LMConfig, c2f_j)
    tiface = Interface.from_modules(
        tc, convert.codec_state_dict_from_jax(codec_np, tc),
        coarse_t, convert.lm_state_dict_from_jax(coarse_np, coarse_t),
        c2f_t, convert.lm_state_dict_from_jax(c2f_np, c2f_t), device="cpu", **chunks)
    return jiface, tiface


@pytest.fixture(scope="module")
def interface(ifaces):
    return ifaces[1]


def _samples(seconds=0.3, sr=8000, freq=220.0):
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None, None, :]


def _sig(seconds=0.3, sr=8000, freq=220.0):
    return AudioSignal(_samples(seconds, sr, freq), sr)


def _codes_mask(interface, seconds=0.3):
    codes = interface.encode(_sig(seconds)).numpy()
    mask = interface.build_mask(codes, seed=0).numpy()
    return codes, mask


@pytest.fixture
def engine_factory():
    """Engines made through this close at the test's end, pass or fail."""
    made = []

    def make(iface, **kw):
        made.append(VampEngine(iface, **kw))
        return made[-1]

    yield make
    for eng in made:
        eng.close()


# ---------------- engine ----------------


def test_engine_single_request(interface, engine_factory):
    eng = engine_factory(interface, max_wait_ms=1.0)
    codes, mask = _codes_mask(interface)
    out = eng.vamp(VampRequest(codes=codes, mask=mask, seed=1, sampling_steps=2), timeout=WAIT)
    assert isinstance(out, np.ndarray) and out.shape == codes.shape
    assert (out != interface.coarse.mask_token).all()


def test_engine_batches_concurrent_heterogeneous(interface, engine_factory):
    eng = engine_factory(interface, max_wait_ms=200.0, max_batch=4)
    codes, mask = _codes_mask(interface)
    # other temperatures and seeds, one static config: one device batch
    futs = [eng.submit(VampRequest(codes=codes, mask=mask, seed=i, temperature=0.8 + 0.2 * i,
                                   sampling_steps=2))
            for i in range(3)]
    outs = [f.result(timeout=WAIT) for f in futs]
    for o in outs:
        assert o.shape == codes.shape
    assert eng.stats["requests"] == 3
    assert eng.stats["batched_requests"] >= 2, "requests should share a batch"


def test_engine_mixed_static_configs(interface, engine_factory):
    eng = engine_factory(interface, max_wait_ms=200.0, max_batch=4)
    codes, mask = _codes_mask(interface)
    f1 = eng.submit(VampRequest(codes=codes, mask=mask, sampling_steps=2))
    f2 = eng.submit(VampRequest(codes=codes, mask=mask, sampling_steps=3))
    f3 = eng.submit(VampRequest(codes=codes, mask=mask, sampling_steps=2, top_p=0.9))
    for f in (f1, f2, f3):
        assert f.result(WAIT).shape == codes.shape
    assert eng.stats["batches"] == 3 and eng.stats["batched_requests"] == 0


def test_engine_tokens_match_the_jax_engine(ifaces, engine_factory):
    """Three requests, batched on both sides, at the deterministic settings:
    each with its own prompt (every 5 steps, offset by the request) in both
    coarse chunks and its own temperature, greedy sampling, no re-masking
    noise, the typical filter cutting."""
    jiface, tiface = ifaces
    codes = np.asarray(jiface.encode(JAudioSignal(_samples(0.4), 8000)))
    assert codes.shape == (1, 4, 100)
    masks = []
    for i in range(3):
        m = np.ones(codes.shape, np.int64)
        m[:, :3, i::5] = 0
        masks.append(m)
    kw = [dict(seed=s, temperature=t, sample_cutoff=-1.0, mask_temperature=0.0,
               sampling_steps=3, typical_mass=0.3, typical_min_tokens=2)
          for s, t in ((1, 1.0), (2, 0.7), (3, 1.3))]
    jeng = JVampEngine(jiface, max_wait_ms=200.0, max_batch=4)
    try:
        jfuts = [jeng.submit(JVampRequest(codes=codes.astype(np.int32),
                                          mask=m.astype(np.int32), **k))
                 for m, k in zip(masks, kw)]
        want = [np.asarray(f.result(timeout=WAIT)) for f in jfuts]
    finally:
        jeng.close()
    eng = engine_factory(tiface, max_wait_ms=200.0, max_batch=4)
    got = [f.result(timeout=WAIT) for f in
           [eng.submit(VampRequest(codes=codes, mask=m, **k)) for m, k in zip(masks, kw)]]
    assert eng.stats["batched_requests"] == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 4, 100)
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


def test_engine_warmup(interface, engine_factory):
    eng = engine_factory(interface, max_wait_ms=100.0, max_batch=4)
    eng.warmup(batch_sizes=(1, 2), sampling_steps=2)
    assert eng.stats["requests"] >= 3  # 1 + 2 warm-up requests went through


def test_engine_request_deterministic_solo_vs_batched(interface, engine_factory):
    """A request's tokens depend only on its own seed: the same alone or
    sharing a device batch (per-row key streams)."""
    codes, mask = _codes_mask(interface)

    def solo(seed, temp):
        eng = engine_factory(interface, max_wait_ms=1.0)
        return eng.vamp(VampRequest(codes=codes, mask=mask, seed=seed, temperature=temp,
                                    sampling_steps=2), timeout=WAIT)

    solo_outs = [solo(7, 1.0), solo(13, 0.9)]
    eng = engine_factory(interface, max_wait_ms=500.0, max_batch=4)
    futs = [eng.submit(VampRequest(codes=codes, mask=mask, seed=7, temperature=1.0,
                                   sampling_steps=2)),
            eng.submit(VampRequest(codes=codes, mask=mask, seed=13, temperature=0.9,
                                   sampling_steps=2))]
    batched_outs = [f.result(timeout=WAIT) for f in futs]
    assert eng.stats["batched_requests"] >= 2, "must actually share a batch"
    np.testing.assert_array_equal(solo_outs[0], batched_outs[0])
    np.testing.assert_array_equal(solo_outs[1], batched_outs[1])
    assert not np.array_equal(batched_outs[0], batched_outs[1])  # other seeds differ


def test_engine_equals_direct_per_row_seed_calls(interface, engine_factory):
    """An engine request is `coarse_vamp(seed=[s])` then
    `coarse_to_fine(seed=[s + 0x9E3779B9])` on its codes, where the length
    is a whole number of coarse chunks (the engine pads others to one, and
    pins the padded chunk's last step)."""
    codes, mask = _codes_mask(interface, 0.4)
    eng = engine_factory(interface, max_wait_ms=1.0)
    out = eng.vamp(VampRequest(codes=codes, mask=mask, seed=2 ** 32 - 3, temperature=0.9,
                               sampling_steps=2), timeout=WAIT)
    knobs = dict(temperature=torch.tensor([0.9]), mask_temperature=torch.tensor([10.5]),
                 sample_cutoff=torch.tensor([1.0]))
    z = interface.coarse_vamp(codes, mask, seed=[2 ** 32 - 3], _sampling_steps=2, **knobs)
    z = interface.coarse_to_fine(z, mask=mask, seed=[(2 ** 32 - 3 + 0x9E3779B9) % 2 ** 32],
                                 **knobs)
    np.testing.assert_array_equal(out, z.numpy())


def test_engine_pipelined_batches(interface, engine_factory):
    """More sequential batches than pipeline_depth: dispatch/collect overlap
    and the bounded in-flight queue must not reorder, drop or mix results."""
    eng = engine_factory(interface, max_wait_ms=1.0, max_batch=1, pipeline_depth=2)
    codes, mask = _codes_mask(interface)
    seeds = [7, 8, 7, 8, 7]
    futs = [eng.submit(VampRequest(codes=codes, mask=mask, seed=s, sampling_steps=2))
            for s in seeds]
    outs = [f.result(timeout=WAIT) for f in futs]
    for o in outs:
        assert o.shape == codes.shape
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[2], outs[4])
    np.testing.assert_array_equal(outs[1], outs[3])
    assert not np.array_equal(outs[0], outs[1])
    assert eng.stats["batches"] == 5


def test_engine_dispatch_error_propagates(interface, engine_factory):
    """A malformed request fails its own future and the engine serves on."""
    eng = engine_factory(interface, max_wait_ms=1.0)
    codes, mask = _codes_mask(interface)
    bad = VampRequest(codes=codes[:, :1, :], mask=mask, sampling_steps=2)
    # Future.exception() tells "failed" (the error) from "never resolved"
    # (TimeoutError)
    exc = eng.submit(bad).exception(timeout=WAIT)
    assert exc is not None
    out = eng.vamp(VampRequest(codes=codes, mask=mask, seed=1, sampling_steps=2), timeout=WAIT)
    assert out.shape == codes.shape


def test_engine_error_reaches_every_future_of_its_group(interface, engine_factory, monkeypatch):
    eng = engine_factory(interface, max_wait_ms=300.0, max_batch=4)
    codes, mask = _codes_mask(interface)

    def broken(*a, **kw):
        raise RuntimeError("the card fell over")

    monkeypatch.setattr(interface, "coarse_to_fine", broken)
    futs = [eng.submit(VampRequest(codes=codes, mask=mask, seed=i, sampling_steps=1))
            for i in range(3)]
    for f in futs:
        exc = f.exception(timeout=WAIT)
        assert isinstance(exc, RuntimeError) and "the card fell over" in str(exc)


def test_engine_close_leaves_no_future_unresolved(interface):
    eng = VampEngine(interface, max_wait_ms=1.0, max_batch=1, pipeline_depth=1)
    codes, mask = _codes_mask(interface)
    futs = [eng.submit(VampRequest(codes=codes, mask=mask, seed=i, sampling_steps=2))
            for i in range(6)]
    eng.close()
    assert not eng._thread.is_alive() and not eng._collector.is_alive()
    assert all(f.done() for f in futs)
    for f in futs:  # each resolved with its tokens or with the engine's closing
        exc = f.exception(timeout=0)
        assert exc is None or "engine closed" in str(exc)


def test_engine_data_parallel_is_not_ported(interface):
    """Data-parallel serving is ported (tests/test_torch_sharded_inference.py);
    it keeps the JAX engine's refusals: without a prior shard() there is no
    dp mesh, and an sp interface has none either."""
    with pytest.raises(AssertionError, match="data_parallel"):
        VampEngine(interface, data_parallel=True)
    try:
        interface.shard(sp=2, devices=["cpu"] * 2)
        with pytest.raises(AssertionError, match="data_parallel"):
            VampEngine(interface, data_parallel=True)
    finally:
        interface.to(interface.device)  # drops the placement
    assert interface.placement.sp == 1 and interface.placement.of(interface.coarse) is None


# ---------------- OSC ----------------


@pytest.mark.parametrize("address,args", [
    ("/process", [1, "vampnet", "/tmp/a.wav", 3.5, True, b"xy"]),
    ("/heartbeat", ["pong"]),
    ("/progress", ["q1", "PROCESSING", False, -7, 0.15, b"abcd", ""]),
    ("/cleanup", None),
])
def test_osc_bytes_match_jax(address, args):
    msg = encode_message(address, args)
    assert msg == josc.encode_message(address, args)
    assert decode_message(msg) == josc.decode_message(msg)


def test_osc_encode_decode_roundtrip():
    msg = encode_message("/process", [1, "vampnet", "/tmp/a.wav", 3.5, True, b"xy"])
    addr, args = decode_message(msg)
    assert addr == "/process"
    assert args[0] == 1 and args[1] == "vampnet" and args[2] == "/tmp/a.wav"
    assert abs(args[3] - 3.5) < 1e-6 and args[4] is True and args[5] == b"xy"
    with pytest.raises(TypeError):
        encode_message("/x", [object()])


def test_osc_server_client_udp():
    got = []
    done = threading.Event()
    disp = Dispatcher()
    disp.map("/hello", lambda addr, *args: (got.append((addr, args)), done.set()))
    server = OSCServer(("127.0.0.1", 0), disp)
    server.start()
    client = OSCClient("127.0.0.1", server.address[1])
    try:
        client.send_message("/hello", [42, "world"])
        assert done.wait(timeout=WAIT)
        assert got[0] == ("/hello", (42, "world"))
    finally:
        client.close()
        server.shutdown()


# ---------------- audio helpers ----------------


def test_audio_signal_file_io_and_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    samples = rng.uniform(-0.9, 0.9, (1, 2, 4000)).astype(np.float32)  # none clipped
    path = tmp_path / "x.wav"
    AudioSignal(samples, 16000).write(path)
    got, want = AudioSignal(path), JAudioSignal(path)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.sample_rate == want.sample_rate == 16000
    assert (got.batch_size, got.num_channels, got.signal_length, got.duration) == \
        (want.batch_size, want.num_channels, want.signal_length, want.duration)
    assert got.audio_data is got.samples
    # a 16-bit round trip: within one step of 1/32767
    np.testing.assert_allclose(got.samples, samples, atol=2 / 32767, rtol=0)
    ex, jex = got.excerpt(0.05, 0.1), want.excerpt(0.05, 0.1)
    np.testing.assert_array_equal(ex.samples, jex.samples)
    cat = signal_concat([ex, got])
    assert cat.length == ex.length + got.length and cat.sample_rate == 16000
    np.testing.assert_array_equal(got.clone().trim(100, 200).samples,
                                  want.clone().trim(100, 200).samples)
    with pytest.raises(ValueError, match="sample_rate"):
        AudioSignal(samples)


@pytest.mark.parametrize("n", [-3, 2, 7])
def test_pitch_shift_matches_jax(n):
    samples = _samples(0.5, 8000, 330) + 0.2 * _samples(0.5, 8000, 95)
    got = pitch_shift(AudioSignal(samples, 8000), n)
    want = jpitch_shift(JAudioSignal(samples, 8000), n)
    assert got.samples.shape == want.samples.shape == samples.shape
    # the same numpy/scipy operations on the same input: rounding only
    np.testing.assert_allclose(got.samples, want.samples, atol=1e-6, rtol=0)
    same = AudioSignal(samples, 8000)
    assert pitch_shift(same, 0) is same


# ---------------- app core ----------------


def test_vamp_core(interface):
    sig = _sig(0.3)
    res = app.vamp_core(
        interface, (sig.sample_rate, sig.samples[0, 0]), seed=7, sampling_steps=2,
        batch_size=2, **{k: v for k, v in app.PRESETS["medium variation"].items()
                         if k in ("periodic_p", "n_mask_codebooks", "dropout")},
    )
    assert len(res.variations) == 2
    sr, wav = res.variations[0]
    assert sr == 8000 and wav.ndim == 1 and len(wav) > 0
    assert res.seed == 7
    assert res.mask.shape[0] == 2
    assert app.PRESETS == japp.PRESETS


def test_vamp_core_requires_audio(interface):
    with pytest.raises(ValueError, match="no input audio"):
        app.vamp_core(interface, None)


class _Recorder:
    """An interface that records what vamp_core asks of it, for either
    package: `signal_cls` builds the decoded signal."""

    def __init__(self, signal_cls):
        self.signal_cls = signal_cls
        self.calls = []
        self.beat_tracker = None
        rng = np.random.default_rng(5)
        self.decoded = (0.1 * rng.standard_normal((2, 1, 2400))).astype(np.float32)

    def load_finetuned(self, name):
        self.calls.append(("load_finetuned", name))
        raise FileNotFoundError("no such model")

    def encode(self, sig):
        self.calls.append(("encode", sig.samples.copy(), sig.sample_rate))
        return np.zeros((1, 4, 75), np.int64)

    def build_mask(self, codes, sig=None, **kw):
        self.calls.append(("build_mask", kw))
        return np.ones_like(codes)

    def set_chunk_size(self, s):
        self.calls.append(("set_chunk_size", s))

    def vamp(self, codes, mask, **kw):
        self.calls.append(("vamp", kw))
        b = kw["batch_size"]
        return np.zeros((b, 4, 75), np.int64), np.ones((b, 4, 75), np.int64)

    def decode(self, zv):
        return self.signal_cls(self.decoded[:zv.shape[0]].copy(), 8000)


@pytest.mark.parametrize("knobs", [
    dict(seed=7, pitch_shift_amt=2, periodic_p=5, n_mask_codebooks=4, dropout=0.1,
         sampletemp=0.8, top_p=0.0, sample_cutoff=0.5, sampling_steps=9, batch_size=2),
    dict(seed=11, model_choice="some fine-tune", typical_filtering=False, typical_mass=0.3,
         typical_min_tokens=8, top_p=0.9, stretch_factor=2, num_feedback_steps=3,
         beat_mask_ms=50, batch_size=1),
])
def test_vamp_core_makes_the_jax_calls_and_matches_its_audio(knobs):
    """The same knobs reach the same interface calls in both packages; the
    pitch-shifted input and the loudness-normalised output agree within
    1e-6 (one fp32 rounding of the same numpy/scipy operations)."""
    samples = np.asarray(_samples(0.3, 8000, 220)[0, 0] * 0.3)
    got_rec, want_rec = _Recorder(AudioSignal), _Recorder(JAudioSignal)
    got = app.vamp_core(got_rec, (8000, samples), **knobs)
    want = japp.vamp_core(want_rec, (8000, samples), **knobs)
    assert got.seed == want.seed == knobs["seed"]
    assert [c[0] for c in got_rec.calls] == [c[0] for c in want_rec.calls]
    for g, w in zip(got_rec.calls, want_rec.calls):
        if g[0] == "encode":
            np.testing.assert_allclose(g[1], w[1], atol=1e-6, rtol=0)
            assert g[2] == w[2]
        else:
            assert g == w
    assert len(got.variations) == len(want.variations) == knobs["batch_size"]
    for (gsr, g), (wsr, w) in zip(got.variations, want.variations):
        assert gsr == wsr == 8000
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    # the output takes the input's loudness
    out = AudioSignal(np.stack([v for _, v in got.variations])[:, None], 8000)
    in_lufs = AudioSignal(samples, 8000).loudness()[0]
    np.testing.assert_allclose(out.loudness(), in_lufs, atol=0.05)


def test_vamp_core_draws_a_seed_for_zero():
    rec = _Recorder(AudioSignal)
    res = app.vamp_core(rec, (8000, np.asarray(_samples()[0, 0])), seed=0, batch_size=1)
    assert 0 <= res.seed < 2 ** 31 - 1
    name, kw = rec.calls[-1]
    assert name == "vamp" and kw["seed"] == res.seed


# ---------------- unloop bridge over real UDP ----------------


def test_unloop_bridge_roundtrip(interface, tmp_path):
    from vampnet_tpu_torch.serve.unloop import UnloopBridge

    results, logs = [], []
    done = threading.Event()
    max_disp = Dispatcher()  # the Max side receives the bridge's messages
    max_disp.map("/process-result", lambda a, *r: (results.append(r), done.set()))
    max_disp.map("/log", lambda a, *r: logs.append(r))
    max_disp.set_default_handler(lambda a, *r: None)
    max_server = OSCServer(("127.0.0.1", 0), max_disp)
    max_server.start()
    bridge = UnloopBridge(ip="127.0.0.1", s_port=max_server.address[1], r_port=0,
                          interface=interface, out_dir=tmp_path)
    server = bridge.osc_manager.make_server()
    server.start()
    client = OSCClient("127.0.0.1", server.address[1])
    try:
        wav_path = tmp_path / "loop.wav"
        _sig(0.3, sr=48000, freq=330).write(wav_path)
        # the Max patch's 18-argument /process message
        client.send_message("/process", [
            "q1", "vampnet", str(wav_path), "default", 5, 0.0, 3,
            200,  # looplength_ms
            1, 0.15, 8, 2, 0, 2, 1.0, 0.0, 0, 1,
        ])
        assert done.wait(timeout=WAIT), "no /process-result received"
        q_id, *files = results[0]
        assert q_id == "q1" and len(files) == 2
        for f in files:
            out = AudioSignal(f)
            assert out.sample_rate == 48000
            assert out.length > 0
    finally:
        client.close()
        server.shutdown()
        max_server.shutdown()


def test_unloop_heartbeat(interface, tmp_path):
    from vampnet_tpu_torch.serve.unloop import UnloopBridge

    beats = []
    done = threading.Event()
    max_disp = Dispatcher()
    max_disp.map("/heartbeat", lambda a, *r: (beats.append(r), done.set()))
    max_disp.set_default_handler(lambda a, *r: None)
    max_server = OSCServer(("127.0.0.1", 0), max_disp)
    max_server.start()
    bridge = UnloopBridge(ip="127.0.0.1", s_port=max_server.address[1], r_port=0,
                          interface=interface, out_dir=tmp_path)
    server = bridge.osc_manager.make_server()
    server.start()
    client = OSCClient("127.0.0.1", server.address[1])
    try:
        client.send_message("/heartbeat", "ping")
        assert done.wait(timeout=WAIT)
        assert beats[0] == ("pong",)
    finally:
        client.close()
        server.shutdown()
        max_server.shutdown()


def test_unloop_needs_a_backend():
    from vampnet_tpu_torch.serve.unloop import UnloopBridge

    with pytest.raises(ValueError, match="need a local interface"):
        UnloopBridge(s_port=9, r_port=0)


# ---------------- token telephone ----------------


def test_tt_trigger_and_release():
    st = tt.State(sample_rate=8000, duration=1.0, hold_seconds=0.05)
    loud = np.random.default_rng(0).normal(0, 0.5, 256)
    quiet = np.zeros(256) + 1e-5

    tt.check_if_record(st, loud)
    assert st.recording and st.record_ramp_in
    st.record_ramp_in = False

    # a quiet block starts the hold; after it expires, the release fires
    tt.check_if_record(st, quiet)
    assert st.cur_hold_time is not None
    time.sleep(0.06)
    released = []
    tt.check_if_record(st, quiet, on_release_callback=lambda s: released.append(True))
    assert st.record_ramp_out and st.input_ready and released


def test_tt_looper_block_roundtrip():
    st = tt.State(sample_rate=8000, blocksize=64, duration=0.5)
    st.loopbuf[:, :] = 0.25  # a loop to play
    out = tt.looper_process_block(st, np.zeros((4, 64)))
    assert out.shape == (4, 64)
    np.testing.assert_allclose(out, 0.25)
    assert st.pos == 64


_STATE_FIELDS = ("loopbuf", "looper_in", "lookback_buf", "recording", "record_ramp_in",
                 "record_ramp_out", "rec_time", "pos", "rms_db", "input_ready")


def _assert_states_equal(got, want):
    for name in _STATE_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


def test_tt_state_machine_matches_jax_on_the_same_blocks(monkeypatch):
    """The audio callback (trigger, lookback, ramped recording, playback)
    driven by the same int16 blocks in both packages: the states and the
    output blocks are identical, and so are the rendered frames. The clock
    that times the release hold advances on every reading, so both see a
    hold of 0 s expire at once."""
    clock = iter(range(10 ** 6))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    kw = dict(sample_rate=8000, blocksize=64, duration=0.5, hold_seconds=0.0)
    got_st, want_st = tt.State(**kw), jtt.State(**kw)
    got_cb = tt.make_audio_callback(got_st, on_release_callback=lambda s: None)
    want_cb = jtt.make_audio_callback(want_st, on_release_callback=lambda s: None)
    rng = np.random.default_rng(9)
    frames = 64
    for i in range(40):
        level = 0.4 if i % 10 < 4 else 0.001
        block = (rng.normal(0, level, (frames, 4)) * 32767).astype(np.int16)
        if i == 25:
            block[:] = 0  # silence passes through
        got_out = np.zeros((frames, 4), np.int16)
        want_out = np.zeros((frames, 4), np.int16)
        got_cb(block, got_out, frames, None, None)
        want_cb(block, want_out, frames, None, None)
        np.testing.assert_array_equal(got_out, want_out)
        _assert_states_equal(got_st, want_st)
        assert tt.render_frame(got_st) == jtt.render_frame(want_st)
    assert got_st.input_ready  # a release happened along the way


def test_tt_telephone_step():
    st = tt.State(sample_rate=8000, duration=0.3)
    st.looper_in[:] = 0.1 * np.sin(2 * np.pi * 220 * np.arange(st.looper_in.shape[1]) / 8000)
    st.input_ready = True
    calls = []

    def fake_vamp(sig):
        calls.append(sig)
        return sig

    next_ch = tt.telephone_step(st, fake_vamp)
    assert next_ch == 1 and st.tt_cur_ch == 1
    assert st.recording_locked  # locked until the cycle comes back to the input channel
    assert len(calls) == 1
    assert np.abs(st.loopbuf[1]).sum() > 0  # the vamped audio landed in channel 1
    for _ in range(3):
        tt.telephone_step(st, fake_vamp)
    assert not st.recording_locked


def test_tt_telephone_step_matches_jax():
    kw = dict(sample_rate=8000, duration=0.3)
    got_st, want_st = tt.State(**kw), jtt.State(**kw)
    tone = 0.1 * np.sin(2 * np.pi * 220 * np.arange(got_st.looper_in.shape[1]) / 8000)
    for st in (got_st, want_st):
        st.looper_in[:] = tone
        st.loopbuf[2] = 0.05 * tone
        st.input_ready = True

    def half_speed(cls):  # a stand-in vamp that changes rate and level
        return lambda sig: cls(sig.samples * 0.5, sig.sample_rate // 2)

    for _ in range(5):
        assert tt.telephone_step(got_st, half_speed(AudioSignal)) == \
            jtt.telephone_step(want_st, half_speed(JAudioSignal))
        # the same loudness and resampling code: one fp32 rounding apart
        np.testing.assert_allclose(got_st.loopbuf, want_st.loopbuf, atol=1e-6, rtol=0)
        assert got_st.recording_locked == want_st.recording_locked


def test_tt_ez_variation_runs_the_staged_api(interface):
    out = tt.ez_variation(interface, _sig(0.3), seed=3)
    assert out.samples.shape == (1, 1, 75 * 32) and np.isfinite(out.samples).all()
    again = tt.ez_variation(interface, _sig(0.3), seed=3)
    np.testing.assert_array_equal(out.samples, again.samples)


def test_tt_render_frame_states():
    st = tt.State(sample_rate=8000, duration=1.0)
    st.rms_db = -20.0
    rows = tt.render_frame(st)
    assert len(rows) == tt.UI_ROWS and all(len(r) == tt.UI_COLS for r in rows)
    frame = "\n".join(rows)
    assert "token telephone" in rows[1]
    assert "make a sound" in frame and "record" in frame
    assert "-20.0dB" in frame
    # -20 dB crosses the -25 dB trigger: the bar shows '#' above the threshold
    assert "#" in "".join(r[3] for r in rows)
    assert rows[tt.UI_ROWS - 1].strip().startswith("|v")
    assert ". 1 ." in frame and ". 4 ." in frame

    st.pos = st.loopbuf.shape[1] // 2
    assert tt.render_frame(st)[tt.UI_ROWS - 1].index("v") > tt.UI_COLS // 3

    st.recording = True
    st.rec_time = 0.25
    frame = "\n".join(tt.render_frame(st))
    assert "recording" in frame and "0.8s left" in frame

    st.recording = False
    st.recording_locked = True
    st.input_channel, st.tt_cur_ch, st.pos = 2, 0, 0
    st.token_telephone_processing = True
    frame = "\n".join(tt.render_frame(st))
    assert "please wait" in frame and "3.0s" in frame and "for your turn :)" in frame
    assert "# 1 #" in frame and ". 2 ." in frame


def test_tt_audio_callback_headless():
    st = tt.State(sample_rate=8000, blocksize=64, duration=0.5, hold_seconds=0.02)
    released = []
    cb = tt.make_audio_callback(st, on_release_callback=lambda s: released.append(True))
    frames = 64
    out = np.zeros((frames, st.num_channels), np.int16)

    cb(np.zeros((frames, st.num_channels), np.int16), out, frames, None, None)
    assert not st.recording and not np.any(out)

    rng = np.random.default_rng(0)
    loud = (rng.normal(0, 0.4, (frames, st.num_channels)) * 32767 * 0.5).astype(np.int16)
    cb(loud, out, frames, None, None)
    assert st.recording
    assert np.abs(st.looper_in).sum() > 0

    quiet = np.ones((frames, st.num_channels), np.int16)
    cb(quiet, out, frames, None, None)
    time.sleep(0.03)
    cb(quiet, out, frames, None, None)
    assert released and st.input_ready and not st.recording

    st.loopbuf[:, :] = 0.25
    cb(quiet, out, frames, None, None)
    assert np.all(np.abs(out.astype(np.int32) - int(0.25 * 32767)) <= 1)


# ---------------- Gradio UI (mock) ----------------


def test_build_demo_wiring_with_mock_gradio(interface, monkeypatch):
    """Build the Gradio UI against a mock module: the wiring runs and the
    named API endpoints exist."""
    gr = mock.MagicMock()
    api_names = []

    class FakeComponent(mock.MagicMock):
        def click(self, *a, **kw):
            if "api_name" in kw:
                api_names.append(kw["api_name"])
            return mock.MagicMock()

    gr.Button.side_effect = lambda *a, **kw: FakeComponent()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    app.build_demo(interface)
    assert gr.Blocks.called
    assert "vamp" in api_names and "vamp_1" in api_names
    assert gr.Slider.call_count >= 10
    assert gr.Dropdown.called
    # the model dropdown lists the (empty) models directory and "default"
    choices = [c.kwargs.get("choices") for c in gr.Dropdown.call_args_list]
    assert ["default"] in choices


# ---------------- profiling ----------------


@pytest.fixture
def tracing():
    """The tracer on and empty for the test, off and empty after it."""
    profiling.clear()
    profiling.enable()
    yield
    profiling.disable()
    profiling.clear()


def test_profiling_timers_and_trace(tmp_path, capsys):
    t = profiling.Timer()
    t.tick("predict")
    assert t.tock("predict") >= 0 and "predict took" in capsys.readouterr().out

    profiling.clear()
    with profiling.trace(str(tmp_path / "a")) as d:  # the spans are on inside a trace
        for _ in range(3):
            with profiling.span("stage"):
                torch.ones(8).sum()
    assert (tmp_path / "a" / "trace.json").exists() and d == str(tmp_path / "a")
    events = json.loads((tmp_path / "a" / "trace.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "vampnet/stage" for e in events) == 3
    s = profiling.summary()
    assert s["stage"]["count"] == 3 and s["stage"]["p50_s"] <= s["stage"]["p95_s"]
    profiling.clear()
    assert profiling.summary() == {}
    session = profiling.start_server(str(tmp_path / "b"))
    torch.ones(8).sum()
    path = session.stop()
    assert json.loads(open(path).read())["traceEvents"]
    with profiling.span("after"):
        pass
    assert profiling.records() == []


def test_profiling_span_is_one_shared_noop_while_off():
    profiling.clear()
    a, b = profiling.span("x"), profiling.span("y", rows=3)
    assert a is b and a.id is None
    with a as inside:
        assert inside is a
    assert profiling.stamp() is None
    assert profiling.records() == [] and profiling.summary() == {}


def test_profiling_spans_nest_per_thread_and_keep_their_ids(tracing):
    def in_another_thread():
        with profiling.span("other"):
            pass

    with profiling.span("outer", request=7) as outer:
        with profiling.span("inner") as inner:
            other = threading.Thread(target=in_another_thread)
            other.start()
            other.join(timeout=WAIT)
    t0 = profiling.stamp()
    profiling.record("queue", t0, request=7)
    by_name = {r.name: r for r in profiling.records()}
    assert [r.name for r in profiling.records()] == ["other", "inner", "outer", "queue"]
    o, i, q = by_name["outer"], by_name["inner"], by_name["queue"]
    assert (o.id, i.id) == (outer.id, inner.id) and len({o.id, i.id, q.id}) == 3
    assert i.parent == o.id and o.parent is None and by_name["other"].parent is None
    assert o.ids == {"request": 7} and i.ids == {} and q.ids == {"request": 7}
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert q.start_ns == t0 <= q.end_ns and q.parent is None
    assert o.tid == i.tid == threading.get_native_id() != by_name["other"].tid
    profiling.clear()
    assert profiling.records() == []


def test_engine_records_a_queue_span_per_request_and_a_dispatch_span_per_group(
        interface, engine_factory, tracing):
    eng = engine_factory(interface, max_wait_ms=200.0, max_batch=4)
    codes, mask = _codes_mask(interface)
    # two static configs: one batch of two groups
    futs = [eng.submit(VampRequest(codes=codes, mask=mask, seed=i, sampling_steps=2 + (i == 2),
                                   trace_id=100 + i)) for i in range(3)]
    for f in futs:
        f.result(WAIT)
    recs = profiling.records()
    queued = {r.ids["request"]: r for r in recs if r.name == "engine.queue"}
    groups = [r for r in recs if r.name == "engine.dispatch"]
    assert sorted(queued) == [100, 101, 102]
    assert eng.stats["batches"] == len(groups) == 2
    assert sorted(sorted(g.ids["requests"]) for g in groups) == [[100, 101], [102]]
    for g in groups:
        assert g.ids["rows"] == len(g.ids["requests"]) and g.end_ns > g.start_ns
        assert all(queued[rid].end_ns <= g.start_ns for rid in g.ids["requests"])


def test_vamp_core_engine_spans_share_the_request_id(interface, engine_factory, tracing):
    from vampnet_tpu_torch.serve.webapp import vamp_core_engine

    eng = engine_factory(interface, max_wait_ms=50.0)
    sig = _sig(0.3)
    res = vamp_core_engine(interface, eng, (sig.sample_rate, sig.samples[0, 0]), seed=5,
                           batch_size=2, sampling_steps=2)
    assert len(res.variations) == 2
    recs = profiling.records()
    (request,) = [r for r in recs if r.name == "webapp.request"]
    (wait,) = [r for r in recs if r.name == "webapp.engine_wait"]
    queued = [r for r in recs if r.name == "engine.queue"]
    assert wait.parent == request.id and wait.ids == {"request": request.id}
    assert [r.ids["request"] for r in queued] == [request.id] * 2
    assert request.start_ns <= wait.start_ns <= wait.end_ns <= request.end_ns
    assert all(request.start_ns <= q.start_ns and q.end_ns <= wait.end_ns for q in queued)


# ---------------- stdlib web app ----------------


@pytest.fixture(scope="module")
def web_server(interface):
    server = make_server(interface, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield server.server_address
    server.shutdown()
    server.server_close()
    th.join(timeout=WAIT)


def _http(addr, method, path, body=None, ctype=None):
    conn = http.client.HTTPConnection(*addr, timeout=WAIT)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_webapp_health_presets_index(web_server):
    status, _, data = _http(web_server, "GET", "/health")
    assert status == 200 and json.loads(data) == {"status": "ok", "models": ["default"]}

    status, _, data = _http(web_server, "GET", "/presets")
    assert status == 200 and json.loads(data) == japp.PRESETS

    status, ctype, data = _http(web_server, "GET", "/")
    assert status == 200 and ctype.startswith("text/html")
    assert b"/api/vamp" in data

    status, _, _ = _http(web_server, "GET", "/nope")
    assert status == 404


def test_webapp_vamp_wav_body_roundtrip(web_server):
    sig = _sig(0.3)
    wav = audio_to_wav_bytes(sig.sample_rate, sig.samples[0, 0])
    status, _, data = _http(
        web_server, "POST",
        "/api/vamp?preset=medium+variation&sampling_steps=2&seed=5&batch_size=2",
        body=wav, ctype="audio/wav")
    assert status == 200, data
    out = json.loads(data)
    assert out["seed"] == 5 and len(out["variations"]) == 2
    out_sr, out_wav = wav_bytes_to_audio(base64.b64decode(out["variations"][0]))
    assert out_sr == out["sample_rate"] == 8000 and len(out_wav) == 75 * 32

    status, ctype, data = _http(web_server, "POST", "/api/vamp?sampling_steps=2&format=wav",
                                body=wav, ctype="audio/wav")
    assert status == 200 and ctype == "audio/wav"
    assert len(wav_bytes_to_audio(data)[1]) == 75 * 32


def test_webapp_vamp_json_body(web_server):
    sig = _sig(0.25)
    payload = json.dumps({
        "audio_b64": base64.b64encode(
            audio_to_wav_bytes(sig.sample_rate, sig.samples[0, 0])).decode(),
        "sample_rate": sig.sample_rate, "sampling_steps": 2, "seed": 9, "top_p": 0,
    }).encode()
    status, _, data = _http(web_server, "POST", "/api/vamp", body=payload,
                            ctype="application/json")
    assert status == 200, data
    out = json.loads(data)
    assert out["seed"] == 9 and len(out["variations"]) == 2
    # raw samples instead of a WAV
    payload = json.dumps({"samples": sig.samples[0, 0].tolist(), "sample_rate": 8000,
                          "sampling_steps": 1, "seed": 4, "batch_size": 1}).encode()
    status, _, data = _http(web_server, "POST", "/api/vamp", body=payload,
                            ctype="application/json")
    assert status == 200 and len(json.loads(data)["variations"]) == 1


def test_webapp_wav_helpers_match_jax():
    from vampnet_tpu.serve import webapp as jwebapp

    x = np.sin(np.linspace(0, 40, 1000)).astype(np.float32) * 1.2  # clipped at 1
    assert audio_to_wav_bytes(8000, x) == jwebapp.audio_to_wav_bytes(8000, x)
    stereo = jwebapp.audio_to_wav_bytes(8000, np.stack([x, -x]) * 0.5)
    sr, got = wav_bytes_to_audio(stereo)
    jsr, want = jwebapp.wav_bytes_to_audio(stereo)
    assert sr == jsr == 8000 and got.shape == (2, 1000)
    np.testing.assert_array_equal(got, want)


def test_webapp_errors(web_server):
    sig = _sig(0.2)
    wav = audio_to_wav_bytes(sig.sample_rate, sig.samples[0, 0])
    status, _, data = _http(web_server, "POST", "/api/vamp?bogus_knob=1", body=wav,
                            ctype="audio/wav")
    assert status == 400 and "bogus_knob" in json.loads(data)["error"]
    status, _, _ = _http(web_server, "POST", "/api/vamp?preset=nope", body=wav,
                         ctype="audio/wav")
    assert status == 400
    status, _, data = _http(web_server, "POST", "/api/vamp", body=b"not a wav",
                            ctype="audio/wav")
    assert status == 500 and json.loads(data)["error"]
    status, _, _ = _http(web_server, "POST", "/elsewhere", body=wav, ctype="audio/wav")
    assert status == 404
    status, _, _ = _http(web_server, "GET", "/health")
    assert status == 200


def test_webapp_engine_concurrent(interface, engine_factory):
    """An engine-backed server: concurrent clients' generates share batches
    (the stats show it); the same seed gives the same audio; knobs the
    engine cannot model take the locked vamp_core path."""
    eng = engine_factory(interface, max_batch=8, max_wait_ms=50.0)
    server = make_server(interface, port=0, engine=eng)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        sig = _sig(0.3)
        wav = audio_to_wav_bytes(sig.sample_rate, sig.samples[0, 0])

        def call(seed, extra=""):
            status, _, data = _http(
                server.server_address, "POST",
                f"/api/vamp?sampling_steps=2&seed={seed}&batch_size=1{extra}",
                body=wav, ctype="audio/wav")
            assert status == 200, data
            return json.loads(data)

        with ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(call, [11, 12, 13, 14], timeout=WAIT))
        assert all(len(o["variations"]) == 1 for o in outs)
        assert {o["seed"] for o in outs} == {11, 12, 13, 14}
        assert eng.stats["requests"] >= 4
        assert eng.stats["batched_requests"] > 0

        a, b = call(21), call(21)
        assert a["variations"] == b["variations"]

        requests_before = eng.stats["requests"]
        out = call(31, extra="&stretch_factor=2")
        assert len(out["variations"]) == 1
        assert len(wav_bytes_to_audio(base64.b64decode(out["variations"][0]))[1]) == 2 * 75 * 32
        assert eng.stats["requests"] == requests_before  # the locked path
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=WAIT)
