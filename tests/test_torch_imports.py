"""The port imports nothing that the machine with the card lacks: no JAX, no
part of the JAX package, none of its serialisation or audio-file modules,
no `triton`, none of the serving stack's optional front ends (Gradio,
sounddevice, blessed, matplotlib) and none of the eval tools' (pandas,
sklearn, umap) at import time. Also: entry points default to the card and
refuse to run quietly on the CPU, and `chip_smoke.py` gives no result
without a card or without the package beside it."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "vampnet_tpu",
           "msgpack", "yaml", "soundfile", "triton", "huggingface_hub",
           # the serving stack's optional front ends, imported where used
           "gradio", "gradio_client", "sounddevice", "blessed", "matplotlib",
           # the eval and analysis tools' optional packages, imported where used
           "pandas", "sklearn", "umap")

_IMPORT_ALL = f"""
import importlib, importlib.abc, pkgutil, sys
import numpy, scipy.signal, torch  # the allowed dependencies load first
BLOCKED = {BLOCKED!r}
for name in list(sys.modules):  # anything they pulled in is forgotten
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import vampnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vampnet_tpu_torch.__path__, "vampnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_missing_packages():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = out.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 45  # every module was walked
    serve = {"vampnet_tpu_torch.serve." + m
             for m in ("app", "engine", "osc", "token_telephone", "unloop", "webapp")}
    assert serve <= set(names), sorted(serve - set(names))
    # the sketch2sound controls and the onset and beat masks
    masks = {"vampnet_tpu_torch." + m for m in ("control", "newmask", "beats", "wavebeat")}
    assert masks <= set(names), sorted(masks - set(names))
    # the trainer: the config reader (no yaml), the loop, datasets, tracker
    # and checkpoint manager (no orbax, no optax)
    trainer = {"vampnet_tpu_torch.config"} | {
        "vampnet_tpu_torch.train." + m
        for m in ("loop", "datasets", "tracker", "checkpoints", "step", "scheduler")}
    assert trainer <= set(names), sorted(trainer - set(names))
    # the eval modules, the sampler's dumps and the entry points
    entry = {"vampnet_tpu_torch." + m for m in (
        "eval", "vggish", "sampling.debug", "hello", "scripts.convert_reference",
        "scripts.exp.train", "scripts.exp.eval", "scripts.exp.fine_tune",
        "scripts.exp.experiment", "scripts.exp.export", "scripts.utils.split",
        "scripts.utils.remove_quiet_files", "scripts.utils.split_long_audio_file",
        "scripts.utils.stage", "scripts.utils.plots", "scripts.utils.gtzan_embeddings",
        "scripts.utils.visualize_embeddings", "scripts.utils.xeno_canto_dl")}
    assert entry <= set(names), sorted(entry - set(names))
    # multi-device inference: meshes, specs, placements, ring attention
    parallel = {"vampnet_tpu_torch." + m for m in (
        "parallel", "parallel.mesh", "parallel.partition", "parallel.placement",
        "ops.ring_attention")}
    assert parallel <= set(names), sorted(parallel - set(names))


_IMPORT_PARALLEL = """
import torch.distributed as dist
import vampnet_tpu_torch.parallel, vampnet_tpu_torch.parallel.placement
import vampnet_tpu_torch.ops.ring_attention
from vampnet_tpu_torch.parallel import make_mesh, make_sp_mesh
make_mesh(tp=2, devices=["cpu"] * 4), make_sp_mesh(devices=["cpu"] * 4)
assert not dist.is_initialized()
print("ok")
"""


def test_parallel_does_not_start_torch_distributed():
    out = subprocess.run([sys.executable, "-c", _IMPORT_PARALLEL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_refuse_without_it(monkeypatch):
    from vampnet_tpu_torch.codec import LAC, CodecConfig
    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = LMConfig(n_heads=2, n_layers=1, n_codebooks=2, latent_dim=4, embedding_dim=32,
                    vocab_size=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VampNetLM(tiny)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LAC(CodecConfig(n_codebooks=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Interface.from_modules(CodecConfig(), {}, tiny, {})
    from vampnet_tpu_torch.train.loop import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train({"codec_ckpt": "unused.vtpu"})


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_gives_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run for real")
    out = _run_chip_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
