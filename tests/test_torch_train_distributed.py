"""Port parity: distributed training through the loop (`train/loop.py`
over a ("dp", "tp") mesh, `train/checkpoints.py` collective saves,
`parallel/mesh.py` jobs of several processes) and the `dryrun_multichip`
counterpart (`vampnet_tpu_torch/graft_entry.py`), on the CPU.

Two gloo ranks run `train()` (spawned, as `tests/test_torch_parallel.py`
starts its ranks) against one process at the same global batch; a state
saved on one mesh resumes on another; the JAX package's `load_lm` reads the
sharded run's `model.vtpu`. The tiny trainer of `tests/test_torch_train_loop.py`.
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from test_torch_util import codec_params_np
from vampnet_tpu.checkpoints import load_lm as jload_lm
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu_torch import checkpoints as tckpt
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.codec import CodecConfig
from vampnet_tpu_torch.convert import lm_state_dict_from_jax
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.parallel import mesh as mesh_mod
from vampnet_tpu_torch.train import loop as loop_mod
from vampnet_tpu_torch.train.checkpoints import CheckpointManager
from vampnet_tpu_torch.train.loop import train
from vampnet_tpu_torch.train.step import ShardedTrainState

CODEC_KW = dict(sample_rate=8000, encoder_dim=8, encoder_rates=(2, 4, 4), decoder_dim=64,
                decoder_rates=(4, 4, 2), n_codebooks=4, codebook_size=32, codebook_dim=4)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The tracker writes no TensorBoard events here, as in the spawned
    ranks (the writer's import takes about 10 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
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
    """`tests/test_torch_train_loop.py`'s `_args` at batch 4, validation
    and samples at step 2."""
    root = Path(root)
    return {
        "codec_ckpt": str(root / "codec.vtpu"), "save_path": str(save_path),
        "num_iters": 2, "batch_size": 4, "val_freq": 2, "sample_freq": 2, "num_workers": 1,
        "VampNet.n_heads": 2, "VampNet.n_layers": 1, "VampNet.n_codebooks": 2,
        "VampNet.latent_dim": 4, "VampNet.embedding_dim": 32, "VampNet.vocab_size": 32,
        "NoamScheduler.warmup": 10,
        "train/AudioLoader.sources": [str(root / "train")],
        "val/AudioLoader.sources": [str(root / "val")],
        "AudioDataset.duration": 0.5, "AudioDataset.loudness_cutoff": -60.0,
        "train/AudioDataset.n_examples": 64, "val/AudioDataset.n_examples": 8,
        **extra,
    }


def _rank_main(rank, port, root, out_dir):
    """One rank of a gloo job of two on localhost: train (dp = 2 over the
    ranks, one position each, one torch thread, no TensorBoard writer) and
    save the gathered state (a collective) beside the ranks' run
    directories."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank))
    import torch.distributed as dist

    mesh_mod.multihost_init()
    state = train(_args(root, Path(out_dir) / f"rank{rank}"), device="cpu", devices=["cpu"])
    assert state.placement.mesh.shape == {"dp": 2, "tp": 1}
    torch.save(state.state_dict(), Path(out_dir) / f"state{rank}.pt")
    dist.destroy_process_group()


def test_two_gloo_ranks_train_as_one_process(root, tmp_path):
    """dp = 2 over two ranks, each loading its rows, against one process
    whose two positions are the two dp groups: the same rows, draws and
    dropout per group, so the parameters and moments agree bit for bit;
    the ranks' files are rank 0's alone."""
    port = mesh_mod._free_port()
    torch.multiprocessing.spawn(_rank_main, args=(port, str(root), str(tmp_path)), nprocs=2,
                                join=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the CPU's sums in one order
    try:
        one = train(_args(root, tmp_path / "one"), device="cpu", devices=["cpu"] * 2)
    finally:
        torch.set_num_threads(threads)
    want = one.state_dict()
    for rank in (0, 1):
        got = torch.load(tmp_path / f"state{rank}.pt", weights_only=True)
        assert got["step"] == want["step"] == 2
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), (rank, k)
        for i, st in want["opt_state"]["adamw"]["state"].items():
            gst = got["opt_state"]["adamw"]["state"][i]
            assert torch.equal(gst["exp_avg"], st["exp_avg"]), (rank, i)
            assert torch.equal(gst["exp_avg_sq"], st["exp_avg_sq"]), (rank, i)
    r0 = tmp_path / "rank0"
    assert (r0 / "latest" / "state" / "state.pt").exists() and (r0 / "args.yml").exists()
    assert (r0 / "metrics.jsonl").read_text() == (tmp_path / "one" / "metrics.jsonl").read_text()
    assert (r0 / "samples" / "step_2").is_dir()
    assert not (tmp_path / "rank1").exists()  # rank 1 writes nothing


def test_state_saved_on_one_mesh_resumes_on_another(root, tmp_path):
    """A state saved at (dp, tp) = (2, 2) holds whole tensors: it resumes
    at (1, 1) bit for bit, and its `model.vtpu` gives the JAX package's
    `load_lm` the run's weights (equal logits)."""
    save = tmp_path / "run"
    sharded = train(_args(root, save, **{"mesh.tp": 2}), device="cpu", devices=["cpu"] * 4)
    assert isinstance(sharded, ShardedTrainState)
    assert sharded.placement.mesh.shape == {"dp": 2, "tp": 2}
    saved, _ = CheckpointManager(save).restore("latest")
    resumed = train(_args(root, save, resume=True), device="cpu")
    assert resumed.step == 2
    now = resumed.state_dict()
    for k, v in saved["params"].items():
        assert torch.equal(now["params"][k], v), k
    for i, st in saved["opt_state"]["adamw"]["state"].items():
        assert torch.equal(now["opt_state"]["adamw"]["state"][i]["exp_avg_sq"], st["exp_avg_sq"])
    # and onto a third mesh, (1, 2): the same state cut again
    other = train(_args(root, save, resume=True, **{"mesh.tp": 2}), device="cpu",
                  devices=["cpu"] * 2)
    assert other.placement.mesh.shape == {"dp": 1, "tp": 2}
    for k, v in other.state_dict()["params"].items():
        assert torch.equal(v, saved["params"][k]), k
    path = save / "latest" / "model.vtpu"
    jcfg, jparams = jload_lm(path)
    cfg, tree = tckpt.load_lm(path)
    jcfg32 = dataclasses.replace(jcfg, compute_dtype="float32")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    lm = VampNetLM(cfg32, device="cpu")
    lm.load_state_dict(lm_state_dict_from_jax(tree, cfg32), strict=True)
    for k, v in lm_state_dict_from_jax(tree, cfg).items():
        assert torch.equal(v, saved["params"][k]), k
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 33, (2, cfg.n_codebooks, 20))  # 32 = MASK
    cbs = rng.standard_normal((cfg.n_codebooks, 32, cfg.latent_dim)).astype(np.float32)
    want = np.asarray(JVampNetLM(jcfg32).apply({"params": jparams}, jnp.asarray(codes),
                                               jnp.asarray(cbs), method="forward_codes"))
    with torch.no_grad():
        got = lm.forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs)).numpy()
    # fp32 through one layer, other summation orders (the loop test's bound)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_main_joins_the_job_when_a_coordinator_is_set(monkeypatch):
    """The counterpart of `tests/test_parallel.py`'s CLI test."""
    from vampnet_tpu_torch import parallel as par

    calls = []
    monkeypatch.setattr(par, "multihost_init", lambda: calls.append(1) or (0, 2))
    monkeypatch.setattr(loop_mod, "train", lambda args, **kw: "trained")
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert loop_mod.main([]) == "trained"
    assert not calls  # no coordinator: one process, no group
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert loop_mod.main([]) == "trained"
    assert calls == [1]


def test_encode_microbatch_is_dropped_at_dp_above_one(root, tmp_path):
    with pytest.warns(UserWarning, match="encode_microbatch=2 ignored"):
        assert loop_mod._encode_microbatch({"encode_microbatch": 2}, 2) is None
    assert loop_mod._encode_microbatch({"encode_microbatch": 2}, 1) == 2
    assert loop_mod._encode_microbatch({}, 4) is None
    # through train(): dp 2 warns and trains
    with pytest.warns(UserWarning, match="ignored"):
        state = train(_args(root, tmp_path / "mb", num_iters=1, val_freq=0, sample_freq=0,
                            encode_microbatch=2), device="cpu", devices=["cpu"] * 2)
    assert state.step == 1 and state.dp == 2


def test_dryrun_multichip_on_eight_cpu_positions():
    from vampnet_tpu_torch import graft_entry

    out = graft_entry.dryrun_multichip(8, device="cpu")
    assert out["train"]["dp"] == 4 and out["train"]["tp"] == 2
    assert np.isfinite(out["train"]["loss"]) and out["train"]["loss"] > 0
    assert out["pipeline"] == {"coarse_positions": 4, "c2f_positions": 4}
    assert out["sp"]["sp"] == 8
