"""Port parity: the training loop and what it stands on (`train/loop.py`,
`train/datasets.py`, `train/tracker.py`, `train/checkpoints.py`) against the
JAX package's, on tiny models and synthetic audio, on the CPU.

Mirrors `tests/test_train_loop.py` and `tests/test_train_s2s.py`: the loader's
batches bit for bit with JAX's on the same WAVs (sharded, several workers,
resumed), the metrics lines byte for byte with the JAX tracker's, the loop
with validation, samples, checkpoints and resume (also through
`python -m vampnet_tpu_torch.train.loop`), a `model.vtpu` that the JAX
package's `load_lm` reads to equal logits, the LoRA fine-tune, async saves
and the crash window, and the sketch2sound loop. Tolerances are stated where
they are asserted.
"""
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import codec_params_np
from vampnet_tpu.checkpoints import load_lm as jload_lm
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.train import datasets as jdatasets
from vampnet_tpu.train.tracker import Tracker as JTracker
from vampnet_tpu_torch import checkpoints as tckpt
from vampnet_tpu_torch import config as tcfg
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.codec import CodecConfig
from vampnet_tpu_torch.convert import lm_state_dict_from_jax
from vampnet_tpu_torch.modules import LMConfig, VampNetLM
from vampnet_tpu_torch.train import datasets as tdatasets
from vampnet_tpu_torch.train.checkpoints import CheckpointManager
from vampnet_tpu_torch.train.loop import train
from vampnet_tpu_torch.train.step import TrainState, make_optimizer
from vampnet_tpu_torch.train.tracker import Tracker

REPO = Path(__file__).resolve().parent.parent
# the codec of tests/test_train_loop.py: 8 kHz, hop 32, 4 codebooks of 32
CODEC_KW = dict(sample_rate=8000, encoder_dim=8, encoder_rates=(2, 4, 4), decoder_dim=64,
                decoder_rates=(4, 4, 2), n_codebooks=4, codebook_size=32, codebook_dim=4)


@pytest.fixture(scope="module")
def data_and_codec(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        d = root / split
        d.mkdir()
        for i in range(3):
            t = np.arange(8000) / 8000
            x = 0.4 * np.sin(2 * np.pi * (100 + 50 * i) * t) + 0.01 * rng.standard_normal(8000)
            AudioSignal(x.astype(np.float32)[None, None, :], 8000).write(d / f"{i}.wav")
    tckpt.save_codec(root / "codec.vtpu", CodecConfig(**CODEC_KW),
                     codec_params_np(JCodecConfig(**CODEC_KW), 0))
    return root


def _args(root, save_path, **extra):
    """tests/test_train_loop.py's `_args`."""
    return {
        "codec_ckpt": str(root / "codec.vtpu"), "save_path": str(save_path),
        "num_iters": 4, "batch_size": 2, "val_freq": 2, "save_iters": [2], "num_workers": 1,
        "VampNet.n_heads": 2, "VampNet.n_layers": 1, "VampNet.n_codebooks": 2,
        "VampNet.latent_dim": 4, "VampNet.embedding_dim": 32, "VampNet.vocab_size": 32,
        "NoamScheduler.warmup": 10,
        "train/AudioLoader.sources": [str(root / "train")],
        "val/AudioLoader.sources": [str(root / "val")],
        "AudioDataset.duration": 0.5, "AudioDataset.loudness_cutoff": -60.0,
        "train/AudioDataset.n_examples": 64, "val/AudioDataset.n_examples": 8,
        **extra,
    }


def _datasets(root, n_examples, **kw):
    out = []
    for mod in (tdatasets, jdatasets):
        loader = mod.AudioLoader(sources=[str(root / "train")])
        out.append(mod.AudioDataset(loader, sample_rate=8000, duration=0.25,
                                    n_examples=n_examples, loudness_cutoff=-60.0, **kw))
    return out


@pytest.mark.parametrize("without_replacement", [True, False])
def test_batchloader_batches_bit_identical_to_jax(data_and_codec, without_replacement):
    tds, jds = _datasets(data_and_codec, 16, without_replacement=without_replacement)
    ref = list(iter(jdatasets.BatchLoader(jds, 2, num_workers=1)))
    assert len(ref) == 8 and ref[0].shape == (2, 2000, 1) and ref[0].dtype == np.float32
    for workers in (1, 2, 4):
        got = list(iter(tdatasets.BatchLoader(tds, 2, num_workers=workers)))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    resumed = list(iter(tdatasets.BatchLoader(tds, 2, num_workers=3, start_idx=4)))
    assert len(resumed) == 6
    for a, b in zip(resumed, ref[2:]):
        np.testing.assert_array_equal(a, b)


def test_batchloader_shards_partition_the_global_batch(data_and_codec):
    tds, jds = _datasets(data_and_codec, 8)
    full = list(iter(tdatasets.BatchLoader(tds, 4, num_workers=1)))
    for pid in (0, 1):
        part = list(iter(tdatasets.BatchLoader(tds, 4, num_workers=2, shard=(pid, 2))))
        jpart = list(iter(jdatasets.BatchLoader(jds, 4, num_workers=1, shard=(pid, 2))))
        assert len(part) == len(jpart) == 2 and part[0].shape[0] == 2
        for p, jp, f in zip(part, jpart, full):
            np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(p, f[2 * pid: 2 * pid + 2])
    with pytest.raises(ValueError):
        tdatasets.BatchLoader(tds, 4, shard=(0, 3))


def test_batchloader_raises_a_worker_error(data_and_codec):
    tds, _ = _datasets(data_and_codec, 8)

    def broken(sig):
        raise OSError("unreadable")

    tds.transform = broken
    with pytest.raises(RuntimeError, match="worker failed"):
        list(iter(tdatasets.BatchLoader(tds, 2, num_workers=2)))


def test_tracker_lines_byte_for_byte_with_jax(tmp_path):
    metrics = {"loss": np.float32(4.25), "accuracy-0.0-0.5/top1/masked": 0.125,
               "grad_norm": torch.tensor(5.5)}
    for name, cls in (("t", Tracker), ("j", JTracker)):
        tr = cls(log_file=str(tmp_path / name / "metrics.jsonl"))
        tr.step = 3
        tr.log("train", {k: float(v) for k, v in metrics.items()})
        tr.log("val", {"loss": 2.0}, step=7)
        first, second = tr.is_best("val"), tr.is_best("val")
        assert first and not second  # the same mean is not better than itself
        sd = tr.state_dict()
        tr.close()
        fresh = cls()
        fresh.load_state_dict(json.loads(json.dumps(sd)))
        assert fresh.mean("val/loss") == 2.0 and fresh.step == 3
    assert (tmp_path / "t" / "metrics.jsonl").read_bytes() == \
        (tmp_path / "j" / "metrics.jsonl").read_bytes()


def test_train_loop_and_resume(data_and_codec, tmp_path):
    root = data_and_codec
    save = tmp_path / "run"
    stats = {}
    state = train(_args(root, save, sample_freq=4), seed=0, device="cpu", stats=stats)
    assert state.step == 4
    for tag in ("latest", "best", "0k"):  # save_iters=[2] -> tag "0k"
        assert (save / tag / "state" / "state.pt").exists(), tag
        assert (save / tag / "model.vtpu").exists() and (save / tag / "tracker.json").exists()
    assert not list(save.rglob("state.prev")) and not list(save.rglob("state.tmp"))
    assert tcfg.load_config(save / "args.yml")["num_iters"] == 4
    lines = [json.loads(x) for x in (save / "metrics.jsonl").read_text().splitlines()]
    train_lines = [x for x in lines if x["label"] == "train"]
    val_lines = [x for x in lines if x["label"] == "val"]
    assert [x["step"] for x in train_lines] == [1, 2, 3, 4]
    assert [x["step"] for x in val_lines] == [2, 4]
    # the JAX step's metric keys: the loss, the stratified accuracies and grad_norm
    from vampnet_tpu.train.step import loss_and_metrics as jloss_and_metrics

    _, jm = jloss_and_metrics(jnp.zeros((1, 2, 2, 32)), jnp.zeros((1, 2, 2), jnp.int32),
                              jnp.ones((1, 4), jnp.int32), jnp.asarray([0.3]))
    assert set(train_lines[0]) == {"step", "label", "grad_norm", *jm}
    assert set(val_lines[0]) == {"step", "label", *jm}
    assert all(np.isfinite(x["loss"]) for x in lines)
    for name in ("reconstructed", "inpainted_prompt", "inpainted_middle"):
        wavs = sorted((save / "samples" / "step_4" / name).glob("*.wav"))
        assert len(wavs) == 2  # the batch's two rows
        sig = AudioSignal(wavs[0])
        assert sig.sample_rate == 8000 and sig.length == 4000
    prompt = AudioSignal(save / "samples" / "step_4" / "inpainted_prompt" / "0.wav").samples
    # the masked middle half is silent: whole frames of 32 samples
    assert np.all(prompt[0, 0, 32 * 32: 32 * 93] == 0) and np.any(prompt[0, 0, :32 * 31] != 0)
    assert [len(stats[k]) for k in ("step_s", "loader_wait_s", "val_s", "sample_s")] == [4, 4, 2, 1]
    # latest and best at 2 and 4, 0k at 2; the end's latest is step 4's, not written again
    assert len(stats["save_s"]) == 5

    cfg, _ = tckpt.load_lm(save / "latest" / "model.vtpu")
    assert cfg.n_layers == 1 and cfg.vocab_size == 32 and cfg.lora_r == 0

    # resume continues from step 4, the loader skipping the 4 batches seen
    state2 = train(_args(root, save, num_iters=6, resume=True), seed=0, device="cpu")
    assert state2.step == 6 and state2.opt_state.count == 6
    steps = [json.loads(x)["step"] for x in (save / "metrics.jsonl").read_text().splitlines()
             if json.loads(x)["label"] == "train"]
    assert steps == [1, 2, 3, 4, 5, 6]
    # the tracker state rode along: the resumed best compares with steps 2 and 4
    best = json.loads((save / "latest" / "tracker.json").read_text())
    assert best["step"] == 6 and "val/loss" in best["bests"]


def test_resume_restores_the_state_exactly(data_and_codec, tmp_path):
    """A resumed run starts from the saved params, moments, update count and
    step, bit for bit."""
    root = data_and_codec
    save = tmp_path / "a"
    first = train(_args(root, save, num_iters=2, val_freq=10), seed=0, device="cpu")
    again = train(_args(root, save, num_iters=2, val_freq=10, resume=True), seed=0,
                  device="cpu")
    assert again.step == first.step == 2 and again.opt_state.count == 2
    for (n, x), (_, y) in zip(first.model.state_dict().items(),
                              again.model.state_dict().items()):
        assert torch.equal(x, y), n
    sa, sb = first.opt_state.adamw.state_dict(), again.opt_state.adamw.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_cli_trains_from_a_yml(data_and_codec, tmp_path):
    """`python -m vampnet_tpu_torch.train.loop --args.load tiny.yml`, then a
    resume through a CLI override."""
    root = data_and_codec
    args = _args(root, tmp_path / "cli", num_iters=2, save_iters=[])
    tcfg.dump_args(args, tmp_path / "tiny.yml")
    cmd = [sys.executable, "-m", "vampnet_tpu_torch.train.loop", "--args.load",
           str(tmp_path / "tiny.yml"), "--device", "cpu"]
    for extra in ([], ["--num_iters", "3", "--resume", "true"]):
        out = subprocess.run(cmd + extra, cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
    assert "[val] step 2" in out.stdout or "resumed" in out.stdout
    tracker = json.loads((tmp_path / "cli" / "latest" / "tracker.json").read_text())
    assert tracker["step"] == 3


def test_model_vtpu_loads_in_jax_with_equal_logits(data_and_codec, tmp_path):
    root = data_and_codec
    save = tmp_path / "run"
    train(_args(root, save, num_iters=2, val_freq=10), seed=0, device="cpu")
    path = save / "latest" / "model.vtpu"
    jcfg, jparams = jload_lm(path)
    cfg, tree = tckpt.load_lm(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    # logits in fp32 on both sides from the one file
    jcfg32 = dataclasses.replace(jcfg, compute_dtype="float32")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    lm = VampNetLM(cfg32, device="cpu")
    lm.load_state_dict(lm_state_dict_from_jax(tree, cfg32), strict=True)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 33, (2, cfg.n_codebooks, 20))  # 32 = MASK
    cbs = rng.standard_normal((cfg.n_codebooks, 32, cfg.latent_dim)).astype(np.float32)
    want = np.asarray(JVampNetLM(jcfg32).apply({"params": jparams}, jnp.asarray(codes),
                                               jnp.asarray(cbs), method="forward_codes"))
    with torch.no_grad():
        got = lm.forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs)).numpy()
    # fp32 through one layer, other summation orders
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # and the trained weights, not fresh ones: they equal the run's params
    state, _ = CheckpointManager(save).restore("latest")
    for k, v in lm_state_dict_from_jax(tree, cfg).items():
        assert torch.equal(v, state["params"][k]), k


def test_finetune_lora_only(data_and_codec, tmp_path):
    root = data_and_codec
    base_save = tmp_path / "base"
    # prng names a JAX stream: accepted, no effect
    train(_args(root, base_save, num_iters=2, val_freq=10, prng="threefry"), seed=0,
          device="cpu")
    ft_save = tmp_path / "ft"
    state = train(_args(root, ft_save, num_iters=2, val_freq=10, fine_tune=True, lora_r=2,
                        init_ckpt=str(base_save / "latest" / "model.vtpu")),
                  seed=1, device="cpu")
    assert (ft_save / "latest" / "lora.vtpu").exists()
    _, base_tree = tckpt.load_lm(base_save / "latest" / "model.vtpu")
    cfg, ft_tree = tckpt.load_lm(ft_save / "latest" / "model.vtpu")
    assert cfg.lora_r == 2
    base = lm_state_dict_from_jax(base_tree, cfg)
    moved = 0
    for name, v in state.model.state_dict().items():
        if name.endswith(("lora_a", "lora_b")):
            moved += name.endswith("lora_b") and bool(v.abs().sum() > 0)  # from zero
            continue
        assert torch.equal(v, base[name]), name  # the base weights, bitwise
    assert moved == 5  # every adapter site's lora_b left zero
    # the adapter file holds the adapters alone, as trained
    from vampnet_tpu_torch.util import flatten_tree

    adapters = flatten_tree(tckpt._load_native(ft_save / "latest" / "lora.vtpu")["params"])
    assert len(adapters) == 10 and all(p[-1] in ("lora_a", "lora_b") for p in adapters)
    sd = state.model.state_dict()
    for path, v in adapters.items():
        assert torch.equal(torch.as_tensor(np.asarray(v)), sd[".".join(path)]), path
    # the JAX package reads the fine-tune's files too
    jcfg, jtree = jload_lm(ft_save / "latest" / "model.vtpu",
                           ft_save / "latest" / "lora.vtpu")
    assert jcfg.lora_r == 2


def _ckpt_state(scale, step):
    cfg = LMConfig(n_heads=2, n_layers=1, n_codebooks=2, latent_dim=4, embedding_dim=32,
                   vocab_size=32, compute_dtype="float32")
    lm = VampNetLM(cfg, device="cpu")
    with torch.no_grad():
        for p in lm.parameters():
            p.fill_(scale)
    state = TrainState.create(lm, make_optimizer(32))
    state.step = step
    return cfg, state


def test_async_checkpoint_saves_commit_and_restore(tmp_path):
    cfg, s1 = _ckpt_state(1.0, 1)
    _, s2 = _ckpt_state(2.0, 2)
    ckpt = CheckpointManager(tmp_path / "run", async_save=True)
    ckpt.save("latest", s1, cfg, tracker_state={"k": 1})
    ckpt.save("latest", s2, cfg, tracker_state={"k": 2})
    # save() copied the state to the host: changing it now changes nothing saved
    with torch.no_grad():
        for p in s2.model.parameters():
            p.fill_(9.0)
    ckpt.save("best", s2, cfg)
    assert ckpt.has_tag("latest") and ckpt.has_tag("best")
    tree, tracker_state = ckpt.restore("latest")
    assert tracker_state == {"k": 2} and tree["step"] == 2
    assert all(bool((v == 2.0).all()) for v in tree["params"].values())
    fresh = _ckpt_state(0.0, 0)[1]
    fresh.load_state_dict(tree)
    assert fresh.step == 2 and all(bool((p == 2.0).all()) for p in fresh.model.parameters())
    best, _ = ckpt.restore("best")
    assert all(bool((v == 9.0).all()) for v in best["params"].values())
    cfg2, _ = jload_lm(tmp_path / "run" / "latest" / "model.vtpu")  # the JAX loader reads it
    assert cfg2.vocab_size == 32
    assert not (tmp_path / "run" / "latest" / "state.prev").exists()


def test_async_save_error_is_raised(tmp_path, monkeypatch):
    cfg, s1 = _ckpt_state(1.0, 1)
    ckpt = CheckpointManager(tmp_path / "run", async_save=True)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    ckpt.save("latest", s1, cfg)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ckpt.wait_until_finished()


def test_checkpoint_crash_window_preserves_previous_state(tmp_path):
    cfg, s1 = _ckpt_state(1.0, 1)
    run = tmp_path / "run"
    ckpt = CheckpointManager(run, async_save=True)
    ckpt.save("latest", s1, cfg, tracker_state={"k": 1})
    ckpt.wait_until_finished()
    # the crash window of save #2: the committed state renamed to state.prev
    # (with its tracker snapshot), the extras rewritten, the new state never
    # committed (a half-written state.tmp left behind)
    tag_dir = run / "latest"
    shutil.copyfile(tag_dir / "tracker.json", tag_dir / "tracker.json.prev")
    (tag_dir / "state").rename(tag_dir / "state.prev")
    (tag_dir / "tracker.json").write_text('{"k": 2}')
    (tag_dir / "state.tmp").mkdir()
    (tag_dir / "state.tmp" / "state.pt").write_bytes(b"truncated")

    fresh = CheckpointManager(run, async_save=True)  # the process after the crash
    assert fresh.has_tag("latest")
    tree, tracker_state = fresh.restore("latest")
    assert tree["step"] == 1 and tracker_state == {"k": 1}
    _, s3 = _ckpt_state(3.0, 3)
    fresh.save("latest", s3, cfg, tracker_state={"k": 3})
    fresh.wait_until_finished()
    assert (tag_dir / "state").exists() and not (tag_dir / "state.prev").exists()
    assert not (tag_dir / "tracker.json.prev").exists() and not (tag_dir / "state.tmp").exists()
    tree, tracker_state = fresh.restore("latest")
    assert tree["step"] == 3 and tracker_state == {"k": 3}


def test_s2s_training_and_samples(data_and_codec, tmp_path):
    """tests/test_train_s2s.py: the controller's loop, its control encoder
    trained, its samples written."""
    root = data_and_codec
    save = tmp_path / "s2s-run"
    args = _args(root, save, num_iters=2, val_freq=2, sample_freq=2, save_iters=[],
                 **{"Sketch2SoundController.ctrl_keys": ["rmsq16"],
                    "train/AudioDataset.n_examples": 8, "val/AudioDataset.n_examples": 4})
    state = train(args, seed=0, device="cpu")
    assert state.step == 2 and state.model.config.ctrl_dims == (("rmsq16", 1),)
    ctrl = {n: p for n, p in state.model.named_parameters() if n.startswith("ctrl_encoder")}
    assert ctrl and all(torch.isfinite(p).all() for p in ctrl.values())
    cfg, tree = tckpt.load_lm(save / "latest" / "model.vtpu")
    assert cfg.ctrl_dims == (("rmsq16", 1),) and "ctrl_encoder" in tree
    assert tckpt.load_lm(save / "best" / "model.vtpu")[1]["ctrl_encoder"]
    for name in ("reconstructed", "inpainted_prompt", "inpainted_middle"):
        assert list((save / "samples" / "step_2" / name).glob("*.wav")), name
    lines = [json.loads(x) for x in (save / "metrics.jsonl").read_text().splitlines()]
    assert {x["label"] for x in lines} == {"train", "val"}
