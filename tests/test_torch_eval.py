"""Port parity: the eval metrics (`vampnet_tpu_torch/eval.py`), VGGish
(`vggish.py`) and the eval script (`scripts/exp/eval.py`) against the JAX
package's, on inputs made from numpy seeds.

The metrics are the same numpy and scipy code on the same arrays: held to
1e-6 relative. VGGish runs fp32 convolutions and products in two libraries
on one seeded torchvggish-layout file: atol 1e-4, rtol 1e-3 on embeddings
of order 1. The eval CSVs must hold the numbers of the JAX script's pandas
CSVs (pandas and numpy sum a float64 mean in other orders: rtol 1e-12).
"""
import csv
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from vampnet_tpu import eval as jeval
from vampnet_tpu import vggish as jvggish
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu_torch import eval as teval
from vampnet_tpu_torch import vggish as tvggish
from vampnet_tpu_torch.audio import AudioSignal


def _tone(freq, seconds=0.5, sr=22050, amp=0.5, noise=0.0, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    x = amp * np.sin(2 * np.pi * freq * t)
    if noise:
        x = x + noise * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)[None, None, :], sr


def _both(samples, sr):
    return JAudioSignal(samples.copy(), sr), AudioSignal(samples.copy(), sr)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(22050, 1024, 40), (16000, 32, 5),
                                              (44100, 2048, 320)])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels):
    got = teval.mel_filterbank(sr, n_fft, n_mels)
    assert got.dtype == np.float32 and got.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_allclose(got, jeval.mel_filterbank(sr, n_fft, n_mels), rtol=1e-6)
    f = np.array([0.0, 440.0, 999.0, 1000.0, 8000.0])
    np.testing.assert_allclose(teval.hz_to_mel(f), jeval.hz_to_mel(f), rtol=1e-12)
    np.testing.assert_allclose(teval.mel_to_hz(teval.hz_to_mel(f)), f, rtol=1e-9, atol=1e-9)


def test_log_mel_and_mel_loss_match_jax():
    a, sr = _tone(440, noise=0.05, seed=1)
    b, _ = _tone(523, noise=0.05, seed=2)
    x = a[0, 0]
    np.testing.assert_allclose(teval.log_mel_spectrogram(x, sr, n_fft=512, n_mels=40),
                               jeval.log_mel_spectrogram(x, sr, n_fft=512, n_mels=40),
                               rtol=1e-6)
    # shorter than one window: padded
    np.testing.assert_allclose(teval.log_mel_spectrogram(x[:100], sr, n_fft=256, n_mels=8),
                               jeval.log_mel_spectrogram(x[:100], sr, n_fft=256, n_mels=8),
                               rtol=1e-6)
    (ja, ta), (jb, tb) = _both(a, sr), _both(b[..., :9000], sr)
    want = jeval.mel_spectrogram_loss(ja, jb)
    assert want > 0.05
    assert teval.mel_spectrogram_loss(ta, tb) == pytest.approx(want, rel=1e-6)
    assert teval.mel_spectrogram_loss(ta, AudioSignal(a.copy(), sr)) < 1e-6
    with pytest.raises(ValueError, match="sample rates"):
        teval.mel_spectrogram_loss(ta, AudioSignal(a, 16000))


def test_default_embedding_and_frechet_distance_match_jax():
    x, sr = _tone(330, seconds=1.0, sr=44100, noise=0.1, seed=3)
    js, ts = _both(np.concatenate([x, 0.5 * x], axis=1), sr)  # stereo -> mono
    np.testing.assert_allclose(teval.default_embedding_fn(ts), jeval.default_embedding_fn(js),
                               rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(0)
    e1, e2 = rng.normal(size=(300, 6)), rng.normal(0.3, 1.2, size=(200, 6))
    stats = [(e.mean(0), np.cov(e, rowvar=False)) for e in (e1, e2)]
    want = jeval.frechet_distance(*stats[0], *stats[1])
    assert teval.frechet_distance(*stats[0], *stats[1]) == pytest.approx(want, rel=1e-6)
    assert abs(teval.frechet_distance(*stats[0], *stats[0])) < 1e-6


def _write_dirs(root, n=4):
    for name, freq, noise, seed in (("baseline", 440, 0.02, 0), ("close", 441, 0.02, 10),
                                    ("far", 3000, 0.3, 20)):
        d = root / name
        d.mkdir()
        for i in range(n):
            samples, sr = _tone(freq + 5 * i, noise=noise, seed=seed + i)
            AudioSignal(samples, sr).write(d / f"{i}.wav")


def test_fad_over_directories_matches_jax(tmp_path):
    _write_dirs(tmp_path)
    fad, jfad = teval.FrechetAudioDistance(), jeval.FrechetAudioDistance()
    for cond in ("close", "far"):
        want = jfad.score(tmp_path / "baseline", tmp_path / cond)
        assert fad.score(tmp_path / "baseline", tmp_path / cond) == pytest.approx(want, rel=1e-6)
    assert fad.score(tmp_path / "baseline", tmp_path / "close") < fad.score(
        tmp_path / "baseline", tmp_path / "far")
    sigs = [AudioSignal(p) for p in sorted((tmp_path / "far").glob("*.wav"))]
    base = [AudioSignal(p) for p in sorted((tmp_path / "baseline").glob("*.wav"))]
    assert fad.score_signals(base, sigs) == pytest.approx(
        fad.score(tmp_path / "baseline", tmp_path / "far"), rel=1e-12)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .wav files"):
        fad.score(tmp_path / "baseline", tmp_path / "empty")


# ---------------------------------------------------------------- VGGish


def _vggish_pth(path, seed=0):
    """`chip_smoke.write_random_vggish`'s torchvggish-layout weights (He
    normal: activations of order 1 through the ReLUs), saved under
    `state_dict` beside an entry that is not a VGGish weight."""
    chip_smoke.write_random_vggish(path, torch.Generator().manual_seed(seed))
    sd = torch.load(path, weights_only=True)
    torch.save({"state_dict": dict(sd, pca_means=torch.zeros(128))}, path)
    return sd


def test_waveform_to_examples_is_jax_s():
    for seconds, sr in ((2.1, 22050), (0.5, 16000), (0.01, 16000), (1.5, 44100)):
        x, _ = _tone(300, seconds=seconds, sr=sr, noise=0.1)
        got = tvggish.waveform_to_examples(x[0, 0], sr)
        want = jvggish.waveform_to_examples(x[0, 0], sr)
        assert got.shape == want.shape and got.shape[1:] == (96, 64)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvggish._htk_mel_filterbank(), jvggish._htk_mel_filterbank())


def test_vggish_embeddings_match_jax(tmp_path):
    path = tmp_path / "vggish.pth"
    sd = _vggish_pth(path)
    loaded = tvggish.vggish_from_torch_checkpoint(path)
    assert set(loaded) == set(sd) and "pca_means" not in loaded
    # 2 s at 22.05 kHz: 2 examples
    x, sr = _tone(300, seconds=2.0, sr=22050, noise=0.1, seed=4)
    js, ts = _both(x, sr)
    emb = tvggish.VGGishEmbedder(path, device="cpu")
    got = emb(ts)
    want = jvggish.VGGishEmbedder(path)(js)
    assert got.shape == want.shape == (2, 128)
    assert np.abs(want).max() > 0.1  # the comparison is not of zeros
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    # the head flattens as torchvggish's VGG.forward does: transpose(1, 3),
    # transpose(1, 2), then view
    feats = emb.model.features(torch.from_numpy(
        tvggish.waveform_to_examples(x[0, 0], sr)[:, None]))
    assert feats.shape == (2, 512, 6, 4)
    flat = torch.transpose(torch.transpose(feats, 1, 3), 1, 2).contiguous().view(2, -1)
    np.testing.assert_allclose(emb.model.embeddings(flat).detach().numpy(), got, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------- the eval script


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_csvs_agree(got, want, rel=1e-12):
    assert got[0] == want[0] and len(got) == len(want)
    for g_row, w_row in zip(sorted(got[1:]), sorted(want[1:])):
        for g, w in zip(g_row, w_row):
            try:
                wf = float(w)
            except ValueError:
                assert g == w
                continue
            assert float(g) == pytest.approx(wf, rel=rel, abs=0.0), (g_row, w_row)


def test_eval_script_writes_the_jax_script_s_csvs(tmp_path):
    """A baseline, a variation and an inpainting condition (its context
    trimmed); the log-mel FAD."""
    from scripts.exp.eval import evaluate as jevaluate
    from vampnet_tpu_torch.scripts.exp.eval import evaluate

    exp = tmp_path / "jax"
    for name, freq in (("baseline", 440), ("variation", 450), ("inpaint_0.1", 445)):
        (exp / name).mkdir(parents=True)
        for i in range(3):
            samples, sr = _tone(freq + i, noise=0.05, seed=i)
            JAudioSignal(samples, sr).write(exp / name / f"{i}.wav")
    shutil.copytree(exp, tmp_path / "port")
    want = jevaluate(str(exp))
    got = evaluate(str(tmp_path / "port"), device="cpu")
    assert len(got) == len(want) == 6
    for g, w in zip(sorted(got, key=lambda m: (m["condition"], m["file"])),
                    sorted(want, key=lambda m: (m["condition"], m["file"]))):
        assert (g["condition"], g["file"]) == (w["condition"], w["file"])
        assert g["mel"] == pytest.approx(w["mel"], rel=1e-6)
        assert g["frechet"] == pytest.approx(w["frechet"], rel=1e-6)
    # the JAX script's CSVs: the same columns and rows, the metrics' numbers
    # (1e-6, as above)
    for name in ("stats-mel.csv", "stats-frechet.csv", "metrics-all.csv"):
        _assert_csvs_agree(_read_csv(tmp_path / "port" / name), _read_csv(exp / name),
                           rel=1e-6)
    # and pandas' own CSVs of the port's metrics, to float64 rounding
    import pandas

    metrics = pandas.DataFrame(got)
    stat = metrics.groupby(["condition"])["mel"].agg(["mean", "count", "std"])
    stat.to_csv(tmp_path / "pandas-stats-mel.csv")
    metrics.to_csv(tmp_path / "pandas-metrics-all.csv", index=False)
    _assert_csvs_agree(_read_csv(tmp_path / "port" / "stats-mel.csv"),
                       _read_csv(tmp_path / "pandas-stats-mel.csv"))
    _assert_csvs_agree(_read_csv(tmp_path / "port" / "metrics-all.csv"),
                       _read_csv(tmp_path / "pandas-metrics-all.csv"))


def test_eval_script_with_vggish_and_a_single_file_condition(tmp_path):
    """`--vggish_ckpt` embeds with VGGish; a condition of one file has an
    empty std, as pandas writes its NaN."""
    from vampnet_tpu_torch.scripts.exp.eval import main

    _vggish_pth(tmp_path / "vggish.pth", seed=1)
    exp = tmp_path / "exp"
    for name, n in (("baseline", 2), ("one", 1)):
        (exp / name).mkdir(parents=True)
        for i in range(n):
            samples, sr = _tone(400 + 30 * i, seconds=2.0, noise=0.1, seed=i)  # 2 examples
            AudioSignal(samples, sr).write(exp / name / f"{i}.wav")
    metrics = main(["--exp_dir", str(exp), "--vggish_ckpt", str(tmp_path / "vggish.pth"),
                    "--device", "cpu"])
    assert len(metrics) == 1 and np.isfinite(metrics[0]["frechet"])
    rows = _read_csv(exp / "stats-frechet.csv")
    assert rows == [["condition", "mean", "count", "std"],
                    ["one", repr(metrics[0]["frechet"]), "1", ""]]
