"""Port parity: the onset and beat masks. `mask._invgamma` and
`onset_mask`, `newmask.py`, `beats.py` (onset detection, the DP beat
tracker, `Beats`, `WaveBeat`), `wavebeat.py` (the dsTCN from a Lightning
state dict, peak picking, `.vtpu` files) and the Interface's
`build_mask(onset_mask_width > 0)`, `make_beat_mask` and `snap_to_beats`,
against the JAX package on the same numpy inputs.

The onset and beat trackers run on the host in numpy and scipy in both
packages, so their indices must be identical; the dsTCN's forward is fp32
convolutions in two frameworks, held to rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from test_torch_interface_staged import _pair
from test_wavebeat import HP, TDsTCN, _click_detector_ckpt, _save_ckpt
from vampnet_tpu import beats as jbeats
from vampnet_tpu import mask as jmask
from vampnet_tpu import newmask as jnewmask
from vampnet_tpu import wavebeat as jwavebeat
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu_torch import beats as tbeats
from vampnet_tpu_torch import checkpoints as tckpt
from vampnet_tpu_torch import mask as tmask
from vampnet_tpu_torch import newmask
from vampnet_tpu_torch import wavebeat as twavebeat
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.interface import Interface
from vampnet_tpu_torch.util import flatten_tree

SR = 22050


def _clicks(seconds=4.0, sr=SR, period=11024, offset=2000, amp=1.0):
    """Single-sample clicks every `period` samples (about 120 BPM)."""
    x = np.zeros(int(seconds * sr), np.float32)
    x[offset::period] = amp
    return x


def _metronome(seconds=6.0, sr=SR, bpm=100.0, seed=0):
    """Decaying 1 kHz ticks (an accented one every 4) over quiet noise."""
    t = np.arange(int(seconds * sr)) / sr
    x = 0.003 * np.random.default_rng(seed).standard_normal(len(t))
    period = 60.0 / bpm
    for k, start in enumerate(np.arange(0.25, seconds - 0.1, period)):
        n = (t >= start) & (t < start + 0.05)
        x[n] += (1.0 if k % 4 == 0 else 0.5) * np.sin(2 * np.pi * 1000 * (t[n] - start)) \
            * np.exp(-(t[n] - start) * 60)
    return x.astype(np.float32)


def _sigs(x, sr=SR):
    return JAudioSignal(x[None, None, :], sr), AudioSignal(x[None, None, :], sr)


# ---------------------------------------------------------------- mask.py, newmask.py


def test_invgamma_matches_jax():
    y = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(tmask._invgamma(torch.from_numpy(y)).numpy(),
                               np.asarray(jmask._invgamma(jnp.asarray(y))), rtol=1e-6, atol=1e-6)
    r = np.linspace(0.05, 0.95, 19, dtype=np.float32)
    np.testing.assert_allclose(tmask._invgamma(tmask._gamma(torch.from_numpy(r))).numpy(), r,
                               atol=1e-5)


@pytest.mark.parametrize("width", [1, 2, 5])
def test_onset_mask_matches_jax_in_both_modules(width):
    z = np.zeros((2, 3, 40), np.int64)
    onsets = [0, 7, 8, 20, 39, 45]  # an edge, neighbours, one past the end
    want = np.asarray(jmask.onset_mask(onsets, jnp.asarray(z), width))
    for mod in (tmask, newmask):
        got = mod.onset_mask(onsets, torch.from_numpy(z), width)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnewmask.onset_mask(onsets, jnp.asarray(z), width)),
                                  want)


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _x(b=3, c=5, t=40):
    return torch.zeros((b, c, t), dtype=torch.int64)


def test_newmask_random_and_random_along_time():
    m, ig = newmask.random(_gen(), _x(), 0.5)
    assert m.shape == ig.shape == (3, 5, 40) and ig.dtype == torch.bool and not ig.any()
    # r = 0.5: gamma = cos(pi / 4), about 71% regenerated
    m, _ = newmask.random(_gen(), _x(b=4, t=2000), 0.5)
    assert abs(float(m.float().mean()) - np.cos(np.pi / 4)) < 0.02
    assert newmask.random_along_time(_gen(), _x(), 0.5).shape == (3, 40)


def test_newmask_stemgen_random_structure():
    m, ig = newmask.stemgen_random(_gen(), _x(b=4, c=5, t=30), 0.5)
    for i in range(4):
        levels = [c for c in range(5) if not ig[i, c].any()]
        assert len(levels) == 1
        c = levels[0]
        assert (m[i, :c] == 0).all() and ig[i, :c].all()
        assert (m[i, c + 1:] == 1).all() and ig[i, c + 1:].all()


def test_newmask_hugo_random_hierarchical():
    m, ig = newmask.hugo_random(_gen(), _x(b=2, c=6, t=50), 0.4)
    for c in range(5):  # a masked codebook has every codebook above masked too
        assert ((m[:, c] == 1) <= (m[:, c + 1] == 1)).all()
    assert (ig.long() <= m).all()


def test_newmask_drop_ones_and_tria_mask():
    out = newmask.drop_ones(_gen(), torch.ones((2, 3, 100), dtype=torch.int64), 0.5)
    assert 0.35 < float(out.float().mean()) < 0.65
    assert not newmask.drop_ones(_gen(), torch.zeros((2, 3, 10), dtype=torch.int64), 0.5).any()
    m = newmask.tria_mask(_gen(), _x(b=4, c=3, t=100), 0.1, 0.4)
    for i in range(4):
        n_keep = int((m[i, 0] == 0).sum())
        assert 10 <= n_keep <= 40
        assert (m[i, :, :n_keep] == 0).all() and (m[i, :, n_keep:] == 1).all()


# ---------------------------------------------------------------- beats.py


@pytest.mark.parametrize("make", [_clicks, _metronome])
def test_onsets_and_dp_beats_match_jax(make):
    x = make()
    js, ts = _sigs(x)
    np.testing.assert_array_equal(tbeats.onset_envelope(x, SR), jbeats.onset_envelope(x, SR))
    onsets = tbeats.detect_onsets(ts)
    np.testing.assert_array_equal(onsets, jbeats.detect_onsets(js))
    assert len(onsets) >= 4
    beats, down = tbeats.DPBeatTracker().extract_beats(ts)
    jb, jd = jbeats.DPBeatTracker().extract_beats(js)
    np.testing.assert_array_equal(beats, jb)
    np.testing.assert_array_equal(down, jd)
    assert len(beats) >= 4 and set(down) <= set(beats)


def test_beats_round_trip(tmp_path):
    b = tbeats.Beats([0.5, 1.0, 1.5, 2.0], [0.5, 1.5])
    path = b.save(tmp_path / "out")
    back = tbeats.Beats.load(tmp_path / "out")
    np.testing.assert_array_equal(back.get_beats(), b.get_beats())
    np.testing.assert_array_equal(back.get_downbeats(), b.get_downbeats())
    # the JAX package reads the same file
    jb = jbeats.Beats.load(path.parent)
    np.testing.assert_array_equal(jb.beat_times, b.beat_times)
    segs = b.beat_segments(AudioSignal(np.zeros((1, 1, 3 * SR), np.float32), SR))
    assert [(s.start, s.end) for s in segs] == [(0.5, 1.0), (1.0, 1.5), (1.5, 2.0), (2.0, 3.0)]
    assert isinstance(tbeats.load_beat_tracker("dp"), tbeats.DPBeatTracker)
    with pytest.raises(ValueError, match="Unknown beat tracker"):
        tbeats.load_beat_tracker("madmom")


# ---------------------------------------------------------------- wavebeat.py


def _random_ckpt(tmp_path):
    torch.manual_seed(0)
    tmodel = TDsTCN(HP).eval()
    with torch.no_grad():  # random BatchNorm statistics, so the folding is exercised
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
    return tmodel, _save_ckpt(tmp_path, tmodel, HP)


def test_dstcn_from_a_lightning_state_dict_matches_jax_and_torch(tmp_path):
    tmodel, path = _random_ckpt(tmp_path)
    cfg, sd = twavebeat.dstcn_from_torch_checkpoint(path)
    jcfg, jparams = jwavebeat.dstcn_from_torch_checkpoint(path)
    assert cfg == twavebeat.DsTCNConfig.from_dict(
        {"sample_rate": jcfg.sample_rate, "noutputs": jcfg.noutputs,
         "blocks": [vars(b) for b in jcfg.blocks]})
    assert cfg.total_stride == 8 and cfg.blocks[1].dilation == 8
    model = twavebeat.DsTCN(cfg)
    model.load_state_dict(sd)
    x = torch.randn(2, 1037, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x).numpy()
        ref = tmodel(x[:, None, :]).transpose(1, 2).numpy()
    want = np.asarray(jwavebeat.DsTCN(jcfg).apply({"params": jparams},
                                                  jnp.asarray(x.numpy())[..., None]))
    assert got.shape == want.shape == ref.shape
    # fp32 convolutions, BatchNorm folded (one product less than torch's)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_wavebeat_vtpu_files_read_in_both_packages(tmp_path):
    _, path = _random_ckpt(tmp_path)
    cfg, sd = tckpt.load_wavebeat(path)
    tckpt.save_wavebeat(tmp_path / "wb.vtpu", cfg, sd)
    from vampnet_tpu import checkpoints as jckpt

    jcfg, jparams = jckpt.load_wavebeat(tmp_path / "wb.vtpu")
    _, jparams_pth = jwavebeat.dstcn_from_torch_checkpoint(path)
    got, want = flatten_tree(jparams), flatten_tree(jparams_pth)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(np.asarray(got[p]), np.asarray(want[p]), err_msg=str(p))
    jckpt.save_wavebeat(tmp_path / "wb_jax.vtpu", jcfg, jparams)
    cfg2, sd2 = tckpt.load_wavebeat(tmp_path / "wb_jax.vtpu")
    assert cfg2 == cfg and set(sd2) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(sd2[k].numpy(), sd[k].numpy(), err_msg=k)
    with pytest.raises(ValueError, match="vampnet_wavebeat"):
        tckpt.load_lm(tmp_path / "wb.vtpu")


def test_wavebeat_activations_and_peaks_match_jax(tmp_path):
    _, path = _random_ckpt(tmp_path)
    x = _metronome(seconds=3.2, sr=44100)
    model = twavebeat.WaveBeatModel.from_checkpoint(path, device="cpu")
    jmodel = jwavebeat.WaveBeatModel.from_checkpoint(path)
    acts = model.activations(x, 44100)  # resampled to 22.05 kHz, padded to 65,536s
    want = jmodel.activations(x, 44100)
    assert acts.shape == want.shape == (int(3.2 * SR) // 8, 2)
    np.testing.assert_allclose(acts, want, rtol=1e-4, atol=1e-5)
    fps = 100.0
    act = np.zeros(500)
    for f in (50, 150, 250, 350, 450):
        act[f], act[f - 1], act[f + 1] = 0.9, 0.6, 0.6
    act[51] = 0.95  # the refractory distance keeps one peak
    np.testing.assert_array_equal(twavebeat.pick_peaks(act, fps),
                                  jwavebeat.pick_peaks(act, fps))
    np.testing.assert_allclose(twavebeat.pick_peaks(act, fps), [0.51, 1.5, 2.5, 3.5, 4.5])


def test_wavebeat_tracker_finds_clicks_and_falls_back_only_without_a_file(tmp_path,
                                                                           monkeypatch):
    path = _click_detector_ckpt(tmp_path, SR)
    tracker = tbeats.load_beat_tracker("wavebeat", ckpt_path=str(path), device="cpu")
    assert isinstance(tracker, tbeats.WaveBeat) and tracker.model is not None
    x = _clicks(seconds=2.0)
    js, ts = _sigs(x)
    beats, down = tracker.extract_beats(ts)
    jb, jd = jbeats.WaveBeat(str(path)).extract_beats(js)
    np.testing.assert_array_equal(beats, jb)
    np.testing.assert_array_equal(down, jd)
    assert len(beats) == 4
    bad = tbeats.WaveBeat(str(tmp_path / "missing.pth"), device="cpu")
    assert bad.model is None
    np.testing.assert_array_equal(bad.extract_beats(ts)[0],
                                  tbeats.DPBeatTracker().extract_beats(ts)[0])
    # the default device is the card: without one it refuses, file or not
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ckpt in (path, tmp_path / "missing.pth"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tbeats.WaveBeat(str(ckpt))



# ---------------------------------------------------------------- the Interface


@pytest.fixture(scope="module")
def interfaces():
    return _pair()


def test_build_mask_with_an_onset_mask_matches_jax(interfaces):
    jiface, tiface = interfaces
    x = _metronome(seconds=1.0, sr=16000)
    jz = np.asarray(jiface.encode(JAudioSignal(x[None, None], 16000)))
    tz = tiface.encode(AudioSignal(x[None, None], 16000))
    np.testing.assert_array_equal(tz.numpy(), jz)
    js, ts = _sigs(x, 16000)
    kw = dict(rand_mask_intensity=1.0, periodic_prompt=0, onset_mask_width=2,
              upper_codebook_mask=3)
    want = np.asarray(jiface.build_mask(jnp.asarray(jz), sig=js, seed=1, **kw))
    got = tiface.build_mask(tz, sig=ts, seed=1, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((got == 0).sum()) < got.numel()  # the onsets are kept
    with pytest.raises(ValueError, match="sig="):
        tiface.build_mask(tz, onset_mask_width=2)


@pytest.mark.parametrize("tracker", ["dp", "wavebeat"])
def test_make_beat_mask_and_snap_to_beats_match_jax(interfaces, tracker, tmp_path):
    jiface, tiface = interfaces
    if tracker == "dp":
        jiface.beat_tracker, tiface.beat_tracker = jbeats.DPBeatTracker(), tbeats.DPBeatTracker()
        x = _metronome(seconds=4.0)
    else:
        path = _click_detector_ckpt(tmp_path, SR)
        jiface.beat_tracker = jbeats.WaveBeat(str(path))
        tiface.beat_tracker = tbeats.WaveBeat(str(path), device="cpu")
        x = _clicks(seconds=2.0)
    js, ts = _sigs(x)
    try:
        masks = []
        for kw in (dict(), dict(before_beat_s=0.01, after_beat_s=0.05, invert=False),
                   dict(mask_downbeats=False, beat_downsample_factor=2)):
            want = np.asarray(jiface.make_beat_mask(js, **kw))
            got = tiface.make_beat_mask(ts, **kw)
            assert got.dtype == torch.int64 and got.shape == (1, 4, tiface.s2t(ts.duration))
            np.testing.assert_array_equal(got.numpy(), want)
            masks.append(got)
        assert (masks[0] == 0).any() and (masks[0] == 1).any()
        np.testing.assert_array_equal(tiface.snap_to_beats(ts).samples,
                                      jiface.snap_to_beats(js).samples)
    finally:
        jiface.beat_tracker = tiface.beat_tracker = None
    with pytest.raises(ValueError, match="beat tracker"):
        tiface.make_beat_mask(ts)


def test_interface_takes_a_wavebeat_checkpoint(tmp_path):
    path = _click_detector_ckpt(tmp_path, SR)
    _, tiface = _pair()
    iface = Interface(tiface.codec, tiface.coarse, tiface.c2f)
    assert iface.beat_tracker is None
    iface._set_beat_tracker(str(path))
    assert isinstance(iface.beat_tracker, tbeats.WaveBeat) and iface.beat_tracker.model is not None
    assert iface.beat_tracker.model.device == torch.device("cpu")


def test_default_takes_the_models_directorys_wavebeat(tmp_path, monkeypatch):
    """`Interface.default()` hands `from_checkpoints` the models directory's
    `wavebeat.vtpu`, else its `wavebeat.pth`, else none (the JAX lookup)."""
    from vampnet_tpu_torch import registry

    monkeypatch.setattr(registry, "MODELS_DIR", tmp_path)
    monkeypatch.setattr(registry, "download_codec", lambda: tmp_path / "codec.vtpu")
    monkeypatch.setattr(registry, "download_default",
                        lambda: (tmp_path / "coarse.vtpu", tmp_path / "c2f.vtpu"))
    seen = []
    monkeypatch.setattr(Interface, "from_checkpoints",
                        classmethod(lambda cls, **kw: seen.append(kw.get("wavebeat_ckpt"))))
    Interface.default(device="cpu")
    (tmp_path / "wavebeat.pth").write_bytes(b"")
    Interface.default(device="cpu")
    (tmp_path / "wavebeat.vtpu").write_bytes(b"")
    Interface.default(device="cpu")
    assert seen == [None, str(tmp_path / "wavebeat.pth"), str(tmp_path / "wavebeat.vtpu")]
