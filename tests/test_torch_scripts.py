"""Port parity: the entry points (`vampnet_tpu_torch/hello.py`,
`scripts/convert_reference.py`, `scripts/exp/*`, `scripts/utils/*`, and
`serve/unloop.py`'s `main`) against the repository's JAX-package scripts,
on the CPU with tiny shapes.

Files that both write are compared: `.vtpu` bytes, YAML values, copied
trees. Tokens are not compared where the scripts draw random seeds; those
runs are held to shapes, finite audio and the files they write.
`huggingface_hub` and `urllib` are replaced by fakes: no test reaches the
network.
"""
import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from test_codec_convert import TCodec
from test_torch_interface_staged import _pair
from test_torch_util import lm_params_np
from test_wavebeat import HP, TDsTCN
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu_torch import convert as tconvert
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.modules import LMConfig

# the synthetic snapshot's shapes (tests/test_convert_reference_pipeline.py)
CODEC_CFG = JCodecConfig(sample_rate=16000, encoder_dim=8, encoder_rates=(2, 4),
                         decoder_dim=32, decoder_rates=(4, 2), n_codebooks=6,
                         codebook_size=32, codebook_dim=4)
LM_KW = dict(n_heads=2, n_layers=2, latent_dim=4, embedding_dim=32, vocab_size=32, dropout=0.0)


def _tone(freq, seconds=0.5, sr=22050, amp=0.5):
    t = np.arange(int(seconds * sr)) / sr
    return AudioSignal((amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None, None], sr)


def _write_lm(path, seed, **kw):
    jcfg = JLMConfig(**LM_KW, **kw)
    tcfg = LMConfig(**dataclasses.asdict(jcfg))
    chip_smoke.write_reference_lm(
        path, tconvert.lm_state_dict_from_jax(lm_params_np(jcfg, seed), tcfg), tcfg)


def _snapshot(root):
    """The upstream hub's layout: codec.pth (DAC layout), coarse.pth and
    c2f.pth (upstream's LM files), wavebeat.pth (Lightning), and one
    fine-tune under loras/."""
    root.mkdir(parents=True)
    torch.manual_seed(0)
    torch.save({"state_dict": TCodec(CODEC_CFG).eval().state_dict(),
                "metadata": {"kwargs": {"sample_rate": CODEC_CFG.sample_rate}}},
               root / "codec.pth")
    coarse, c2f = dict(n_codebooks=2), dict(n_codebooks=6, n_conditioning_codebooks=2)
    _write_lm(root / "coarse.pth", 1, **coarse)
    _write_lm(root / "c2f.pth", 2, **c2f)
    torch.manual_seed(3)
    torch.save({"state_dict": TDsTCN(HP).eval().state_dict(), "hyper_parameters": HP},
               root / "wavebeat.pth")
    (root / "loras" / "myfinetune").mkdir(parents=True)
    _write_lm(root / "loras" / "myfinetune" / "coarse.pth", 3, **coarse)
    _write_lm(root / "loras" / "myfinetune" / "c2f.pth", 4, **c2f)
    return root


VTPU = ("codec.vtpu", "coarse.vtpu", "c2f.vtpu", "wavebeat.vtpu",
        "loras/myfinetune/coarse.vtpu", "loras/myfinetune/c2f.vtpu")


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """The snapshot converted by the JAX package's stage 1 and by the port's
    stages 1, 2 (the codec's round trip on the CPU) and 4."""
    from scripts.convert_reference import convert_reference as jconvert_reference
    from vampnet_tpu_torch.scripts.convert_reference import convert_reference

    root = tmp_path_factory.mktemp("convert")
    snap = _snapshot(root / "snapshot")
    jconvert_reference(str(snap), out=str(root / "jax"), parity=False, goldens=False)
    out = convert_reference(str(snap), out=str(root / "zoo"), device="cpu")
    return root, out


def test_convert_reference_writes_the_jax_script_s_bytes(zoo):
    root, out = zoo
    for f in VTPU:
        assert (out / f).read_bytes() == (root / "jax" / f).read_bytes(), f
    report = (out / "CONVERSION_REPORT.md").read_text()
    for line in ("## 1. convert", "- codec.pth -> codec.vtpu (16000 Hz, 6 cb x 32)",
                 "- coarse.pth -> coarse.vtpu (2L/2H/32d, 2 cb / 0 cond)",
                 "- c2f.pth -> c2f.vtpu (2L/2H/32d, 6 cb / 2 cond)",
                 "- loras/myfinetune converted", "## 2. parity smoke",
                 "distinct tokens, decode finite", "LM logits against the upstream "
                 "implementation: not run", "## 3. reference golden tokens: not run"):
        assert line in report, line
    assert "wavebeat.pth -> wavebeat.vtpu (" in report


def test_convert_reference_cli_without_the_smoke(zoo, tmp_path):
    from vampnet_tpu_torch.scripts.convert_reference import main

    root, _ = zoo
    out = main([str(root / "snapshot"), "--out", str(tmp_path / "z"), "--no-parity"])
    assert (out / "c2f.vtpu").read_bytes() == (root / "jax" / "c2f.vtpu").read_bytes()
    assert "## 2." not in (out / "CONVERSION_REPORT.md").read_text()
    with pytest.raises(FileNotFoundError, match="codec.pth missing"):
        main([str(tmp_path), "--out", str(tmp_path / "y"), "--device", "cpu"])


def test_hello_quickstart_runs_on_the_converted_zoo(zoo, tmp_path, monkeypatch):
    """hello.main on the models directory that convert_reference wrote:
    Interface.default, the fine-tune picked and swapped in, encode,
    build_mask, vamp, decode, write."""
    from vampnet_tpu_torch import hello, registry
    from vampnet_tpu_torch.interface import Interface

    _, out = zoo
    monkeypatch.setattr(registry, "MODELS_DIR", out)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    iface = Interface.default(device="cpu")
    assert iface.coarse_path.suffix == ".vtpu" and iface.beat_tracker.model is not None
    # the tiny codec's frame rate is 2 kHz: chunks of 32 and 16 tokens
    iface.set_chunk_size(0.016)
    iface.c2f.chunk_size_s = 0.008
    sr = CODEC_CFG.sample_rate
    x = 0.2 * np.sin(2 * np.pi * 220 * np.arange(CODEC_CFG.hop_length * 40) / sr)
    AudioSignal(x[None, None].astype(np.float32), sr).write(tmp_path / "asset.wav")
    sig = hello.main(asset=str(tmp_path / "asset.wav"), out=str(tmp_path / "o" / "out.wav"),
                     periodic_prompt=3, upper_codebook_mask=2, interface=iface,
                     _sampling_steps=2)
    assert iface.coarse_path == out / "loras" / "myfinetune" / "coarse.vtpu"
    written = AudioSignal(tmp_path / "o" / "out.wav")
    assert written.length == sig.length == CODEC_CFG.hop_length * 40
    assert np.isfinite(sig.samples).all() and np.abs(sig.samples).max() > 0


def test_unloop_main_reads_its_settings_from_the_command_line(monkeypatch):
    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.serve import unloop

    made = []

    class FakeBridge:
        def __init__(self, **kw):
            made.append(kw)
            self.osc_manager = types.SimpleNamespace(start_server=lambda: None)

    monkeypatch.setattr(unloop, "UnloopBridge", FakeBridge)
    unloop.main(["--vampnet_url", "http://localhost:7860/", "--s_port", "9003"])
    assert made[-1] == dict(ip="127.0.0.1", s_port=9003, r_port=8001, interface=None,
                            vampnet_url="http://localhost:7860/")
    devices = []
    monkeypatch.setattr(Interface, "default",
                        classmethod(lambda cls, device: devices.append(device) or "iface"))
    unloop.main(["--device", "cpu"])
    assert devices == ["cpu"] and made[-1]["interface"] == "iface"
    assert made[-1]["vampnet_url"] is None


# ---------------------------------------------------------------- scripts/exp


def test_train_script_is_the_loop_s_main():
    from vampnet_tpu_torch.scripts.exp import train
    from vampnet_tpu_torch.train import loop

    assert train.main is loop.main


def test_fine_tune_writes_the_jax_script_s_configs(tmp_path):
    from scripts.exp.fine_tune import fine_tune as jfine_tune
    from vampnet_tpu_torch.config import loads
    from vampnet_tpu_torch.scripts.exp.fine_tune import main

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jfine_tune(["my/audio", "more audio"], "m", conf_root=str(tmp_path / "jax"))
    got = main(["--audio_folders", "my/audio", "more audio", "--name", "m",
                "--conf_root", str(tmp_path / "port")])
    for name in ("c2f.yml", "coarse.yml", "interface.yml"):
        text = (got / name).read_text()
        j = yaml.safe_load((want / name).read_text())
        assert list(yaml.safe_load(text)) == list(j)  # the keys, in order
        assert yaml.safe_load(text) == j and loads(text) == j
    assert j["AudioLoader.sources"] == [["my/audio", "more audio"]]
    with pytest.raises(FileNotFoundError, match="configs directory"):
        main(["--audio_folders", "a", "--name", "m", "--conf_root", str(tmp_path / "none")])


def test_experiment_registry_is_the_jax_script_s():
    from scripts.exp.experiment import EXP_REGISTRY as JREGISTRY
    from vampnet_tpu_torch.scripts.exp.experiment import EXP_REGISTRY, calculate_bitrate

    assert {k: sorted(v) for k, v in EXP_REGISTRY.items()} == {
        k: sorted(v) for k, v in JREGISTRY.items()}
    iface = types.SimpleNamespace(codec_config=types.SimpleNamespace(sample_rate=44100,
                                                                     hop_length=512))
    assert calculate_bitrate(iface, 4, 2) == pytest.approx(44100 / 512 * 20)


@pytest.fixture(scope="module")
def interface():
    _, tiface = _pair()
    return tiface


def test_experiment_writes_every_condition(interface, tmp_path):
    """The registry's conditions on two excerpts drawn through the training
    loader (all but opus, which needs ffmpeg, and the beat mask, which needs
    a beat tracker), then main with a sampling-steps grid."""
    from vampnet_tpu_torch.scripts.exp import experiment as ex

    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        _tone(220 * (i + 1), seconds=0.4).write(src / f"a{i}.wav")
    conds = {"baseline": ex.baseline, "reconstructed": ex.reconstructed,
             "coarse2fine": ex.coarse2fine, "cc": ex.CoarseCond(1, 4),
             "noise": ex.mask_ratio_1_step(0.5), "steps_1": ex.num_sampling_steps(1),
             "inpaint_0.02": ex.inpaint(0.02), "token_noise": ex.token_noise(0.3)}
    out = ex.run_conditions(interface, [str(src)], tmp_path / "out", conds, max_excerpts=5)
    n = interface.s2t(interface.coarse.chunk_size_s) * interface.codec_config.hop_length
    for name in conds:
        wavs = sorted((out / name).glob("*.wav"))
        assert [w.name for w in wavs] == ["0.wav", "1.wav"], name
        for w in wavs:
            sig = AudioSignal(w)
            assert sig.sample_rate == interface.codec_config.sample_rate
            assert abs(sig.length - n) <= interface.codec_config.hop_length, name
            assert np.isfinite(sig.samples).all()
    base = AudioSignal(out / "reconstructed" / "0.wav").samples
    assert not np.array_equal(AudioSignal(out / "token_noise" / "0.wav").samples, base)
    # main over a registry grid; excerpts already written are skipped
    grid = {"steps_1": ex.num_sampling_steps(1), "steps_2": ex.num_sampling_steps(2)}
    ex.EXP_REGISTRY["test-grid"] = grid
    try:
        res = ex.main(["--sources", str(src), "--output_dir", str(tmp_path / "out"),
                       "--exp_type", "test-grid", "--max_excerpts", "2"], interface=interface)
    finally:
        del ex.EXP_REGISTRY["test-grid"]
    assert sorted(p.name for p in (res / "steps_2").iterdir()) == ["0.wav", "1.wav"]
    with pytest.raises(ValueError, match="Unknown exp_type"):
        ex.main(["--exp_type", "none"], interface=interface)


def test_export_copies_checkpoints_and_uploads_through_hfapi(tmp_path, monkeypatch):
    import scripts.exp.export as jexport
    from vampnet_tpu_torch.scripts.exp import export as texport

    for mod, name in ((jexport, "jax"), (texport, "port")):
        monkeypatch.setattr(mod, "MODELS_DIR", tmp_path / name / "models")
    runs = tmp_path / "runs" / "m1"
    for model in ("coarse", "c2f"):
        d = runs / model / "latest"
        d.mkdir(parents=True)
        (d / "model.vtpu").write_bytes(model.encode())
        (d / "lora.vtpu").write_bytes(b"y" + model.encode())
    uploads = []

    class FakeHfApi:
        def upload_file(self, **kw):
            uploads.append(kw)

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(HfApi=FakeHfApi))
    want = jexport.export("m1", runs_dir=str(tmp_path / "runs"))
    got = texport.main(["--name", "m1", "--runs_dir", str(tmp_path / "runs"),
                        "--repo_id", "me/zoo", "--upload"])
    assert sorted(p.name for p in got.iterdir()) == sorted(p.name for p in want.iterdir()) == [
        "c2f.lora.vtpu", "c2f.vtpu", "coarse.lora.vtpu", "coarse.vtpu"]
    for p in want.iterdir():
        assert (got / p.name).read_bytes() == p.read_bytes()
    assert sorted(u["path_in_repo"] for u in uploads) == [
        "loras/m1/c2f.lora.vtpu", "loras/m1/c2f.vtpu", "loras/m1/coarse.lora.vtpu",
        "loras/m1/coarse.vtpu"]
    assert {u["repo_id"] for u in uploads} == {"me/zoo"}
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        texport.export("m2", runs_dir=str(tmp_path / "runs"))


# ---------------------------------------------------------------- scripts/utils


def test_split_long_audio_file_writes_the_jax_script_s_windows(tmp_path):
    from scripts.utils.split_long_audio_file import split_long_audio_file as jsplit
    from vampnet_tpu_torch.scripts.utils.split_long_audio_file import split_long_audio_file

    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        _tone(220, seconds=3.0).write(tmp_path / name / "long.wav")
    want = jsplit(str(tmp_path / "jax" / "long.wav"), max_chunk_size_s=1)
    got = split_long_audio_file(str(tmp_path / "port" / "long.wav"), max_chunk_size_s=1)
    names = sorted(p.name for p in got.iterdir())
    assert len(names) >= 4 and names == sorted(p.name for p in want.iterdir())
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes()


def test_remove_quiet_files_keeps_what_the_jax_script_keeps(tmp_path):
    from scripts.utils.remove_quiet_files import remove_quiet_files as jremove
    from vampnet_tpu_torch.scripts.utils.remove_quiet_files import remove_quiet_files

    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    _tone(440, amp=0.5).write(src / "loud.wav")
    _tone(440, amp=0.001).write(src / "quiet.wav")
    _tone(330, amp=0.01).write(src / "sub" / "soft.wav")
    want = jremove(src, tmp_path / "jax", min_loudness=-40)
    got = remove_quiet_files(src, tmp_path / "port", min_loudness=-40)
    assert (got / "loud.wav").exists() and not (got / "quiet.wav").exists()
    assert sorted(p.relative_to(got) for p in got.rglob("*.wav")) == sorted(
        p.relative_to(want) for p in want.rglob("*.wav"))


def test_train_test_split_is_the_jax_script_s(tmp_path, monkeypatch):
    from scripts.utils.split import train_test_split as jsplit
    from vampnet_tpu_torch.scripts.utils.split import train_test_split

    for name in ("jax", "port"):
        folder = tmp_path / name / "audio"
        folder.mkdir(parents=True)
        for i in range(10):
            _tone(440 + i, seconds=0.1).write(folder / f"{i}.wav")
    jsplit(str(tmp_path / "jax" / "audio"), test_size=0.2, assume_yes=True)
    train_test_split(str(tmp_path / "port" / "audio"), test_size=0.2, assume_yes=True)
    for split, n in (("train", 8), ("test", 2)):
        got = sorted(p.name for p in (tmp_path / "port" / f"audio-{split}").glob("*.wav"))
        assert len(got) == n
        assert got == sorted(p.name for p in (tmp_path / "jax" / f"audio-{split}").glob("*.wav"))
    monkeypatch.setattr("builtins.input", lambda _prompt: "n")
    assert train_test_split(str(tmp_path / "port" / "audio")) is None


def test_stage_records_the_commit(tmp_path):
    from vampnet_tpu_torch.scripts.utils.stage import run

    out = run(run_dir=str(tmp_path), name="snap1")
    assert out == tmp_path / "snap1"
    commit = (out / "git-commit.txt").read_text()
    assert len(commit) == 40 and int(commit, 16) >= 0
    assert run(run_dir=str(tmp_path), recent=True) == out


def test_xeno_canto_download_with_urllib_faked(tmp_path, monkeypatch):
    import urllib.request

    from vampnet_tpu_torch.scripts.utils import xeno_canto_dl as xc

    queries, fetched = [], []

    class Response:
        def __init__(self, body):
            self.body = body

        def read(self):
            return self.body

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def urlopen(url):
        queries.append(url)
        recs = [{"id": "1", "file": "//xc.example/1.mp3"},
                {"id": "2", "file": "https://xc.example/2.mp3"},
                {"id": "3", "file": "https://xc.example/3.mp3"}]
        return Response(json.dumps({"recordings": recs}).encode())

    def urlretrieve(url, dest):
        if url.endswith("2.mp3"):
            raise urllib.error.URLError("offline")
        fetched.append(url)
        dest.write_bytes(b"mp3")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    assert xc.download_species("Blue Jay", tmp_path, max_recordings=3) == 2
    assert queries == [f"{xc.API}?query=Blue%20Jay%20q%3AA"]
    assert fetched == ["https://xc.example/1.mp3", "https://xc.example/3.mp3"]
    assert sorted(p.name for p in (tmp_path / "Blue_Jay").iterdir()) == ["1.mp3", "3.mp3"]
    # files already there are kept and not fetched again
    assert xc.download_species("Blue Jay", tmp_path, max_recordings=3) == 0
    monkeypatch.setattr(xc, "SPECIES", ["Blue Jay", "House Finch"])
    assert xc.main(["--output_dir", str(tmp_path), "--max_per_species", "1"]) == 1


def test_gtzan_embeddings_match_the_jax_script_s(tmp_path):
    """One coarse-LM layer's time mean per excerpt: the JAX script's
    `return_activations` against the port's forward hooks, fp32."""
    from scripts.utils.gtzan_embeddings import extract_embeddings as jextract
    from vampnet_tpu_torch.scripts.utils.gtzan_embeddings import extract_embeddings

    jiface, tiface = _pair()
    for i, genre in enumerate(("blues", "jazz")):
        (tmp_path / "gtzan" / genre).mkdir(parents=True)
        for j in range(2):
            _tone(200 + 100 * i + 30 * j, seconds=0.2).write(tmp_path / "gtzan" / genre /
                                                            f"{genre}.{j}.wav")
    for layer in (-1, 0):
        want, jlabels = jextract(jiface, str(tmp_path / "gtzan"), str(tmp_path / "j"),
                                 duration=0.15, layer=layer)
        got, labels = extract_embeddings(tiface, str(tmp_path / "gtzan"), str(tmp_path / "t"),
                                         duration=0.15, layer=layer)
        assert labels == jlabels == ["blues", "blues", "jazz", "jazz"]
        assert got.shape == want.shape == (4, tiface.coarse.config.embedding_dim)
        # fp32 layers in two libraries
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert json.loads((tmp_path / "t" / "labels.json").read_text()) == labels
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "embeddings.npz")["embeddings"], got)


def test_visualize_embeddings_projects_as_the_jax_script(tmp_path):
    from scripts.utils.visualize_embeddings import dim_reduce as jdim_reduce
    from vampnet_tpu_torch.scripts.utils.visualize_embeddings import main

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(12, 8))
    labels = ["a"] * 6 + ["b"] * 6
    np.savez(tmp_path / "embeddings.npz", embeddings=emb)
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    got = main(["--embeddings", str(tmp_path), "--method", "pca"])
    want = jdim_reduce(emb, labels, str(tmp_path / "j.png"), method="pca")
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert (tmp_path / "projection.png").exists()
    with pytest.raises(ValueError, match="unknown method"):
        main(["--embeddings", str(tmp_path), "--method", "lda"])


def test_plot_metrics_draws_both_panels():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas

    from vampnet_tpu_torch.scripts.utils.plots import plot_metrics

    metrics = pandas.DataFrame({"mel": [1.0, 1.2, 2.0, 2.5], "frechet": [3.0, 3.0, 5.0, 5.0],
                                "condition": ["a", "a", "b", "b"], "file": ["0", "1", "0", "1"]})
    fig = plot_metrics(metrics, {"a": "A", "b": "B"}, "t", {"A": "red"})
    assert len(fig.axes) == 2
    assert [p.get_height() for p in fig.axes[1].patches] == [3.0, 5.0]
    plt.close(fig)


def test_jax_audio_signal_reads_the_port_s_wavs(tmp_path):
    """The scripts' WAVs are read the same by both packages."""
    sig = _tone(300)
    sig.write(tmp_path / "x.wav")
    np.testing.assert_array_equal(AudioSignal(tmp_path / "x.wav").samples,
                                  JAudioSignal(tmp_path / "x.wav").samples)
