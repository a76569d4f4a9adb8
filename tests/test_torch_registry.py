"""The port's model registry (`vampnet_tpu_torch/registry.py`): the cases of
`tests/test_registry.py` against it, with `huggingface_hub` replaced by a
fake that fails as an offline hub does (nothing here reaches a network),
and the models directory from `VAMPNET_MODELS_DIR`.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from vampnet_tpu_torch import registry


@pytest.fixture
def models_dir(tmp_path, monkeypatch):
    d = tmp_path / "models" / "vampnet"
    d.mkdir(parents=True)
    monkeypatch.setattr(registry, "MODELS_DIR", d)
    return d


def _patch_hub(monkeypatch, fn):
    """Install a fake huggingface_hub with the given hf_hub_download."""
    mod = types.ModuleType("huggingface_hub")
    mod.hf_hub_download = fn
    # list_finetuned imports HfFileSystem; make it fail like offline
    class _FS:
        def __init__(self):
            raise OSError("offline")

    mod.HfFileSystem = _FS
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)


def test_local_file_wins_without_touching_hub(models_dir, monkeypatch):
    (models_dir / "codec.pth").write_bytes(b"x")

    def boom(**kw):  # must never be called
        raise AssertionError("hub touched despite local file")

    _patch_hub(monkeypatch, boom)
    assert registry.download_codec() == str(models_dir / "codec.pth")


def test_native_vtpu_preferred_over_torch(models_dir, monkeypatch):
    (models_dir / "codec.pth").write_bytes(b"torch")
    (models_dir / "codec.vtpu").write_bytes(b"native")
    _patch_hub(monkeypatch, lambda **kw: pytest.fail("hub touched"))
    assert registry.download_codec() == str(models_dir / "codec.vtpu")


def test_offline_failure_raises_filenotfound_with_context(models_dir, monkeypatch):
    def offline(**kw):
        raise OSError("connection refused")

    _patch_hub(monkeypatch, offline)
    with pytest.raises(FileNotFoundError) as ei:
        registry.download_codec(repo_id="some/repo")
    msg = str(ei.value)
    # the message says what was missing and where it was looked for
    assert "codec.pth" in msg
    assert "some/repo" in msg
    assert "connection refused" in msg


def test_download_default_wavebeat_optional(models_dir, monkeypatch):
    """coarse/c2f must exist; a missing wavebeat is no error."""
    (models_dir / "coarse.vtpu").write_bytes(b"n")
    (models_dir / "c2f.vtpu").write_bytes(b"n")

    def offline(**kw):
        raise OSError("offline")

    _patch_hub(monkeypatch, offline)
    coarse, c2f = registry.download_default()
    assert coarse.endswith("coarse.vtpu") and c2f.endswith("c2f.vtpu")


def test_download_default_missing_core_model_raises(models_dir, monkeypatch):
    (models_dir / "coarse.vtpu").write_bytes(b"n")  # c2f missing

    def offline(**kw):
        raise OSError("offline")

    _patch_hub(monkeypatch, offline)
    with pytest.raises(FileNotFoundError, match="c2f.pth"):
        registry.download_default()


def test_download_finetuned_nested_path(models_dir, monkeypatch):
    lora = models_dir / "loras" / "mymodel"
    lora.mkdir(parents=True)
    (lora / "coarse.vtpu").write_bytes(b"n")
    (lora / "c2f.vtpu").write_bytes(b"n")
    _patch_hub(monkeypatch, lambda **kw: pytest.fail("hub touched"))
    coarse, c2f = registry.download_finetuned("mymodel")
    assert Path(coarse) == lora / "coarse.vtpu"
    assert Path(c2f) == lora / "c2f.vtpu"


def test_failed_download_cleans_stale_locks(models_dir, monkeypatch):
    """A failed download leaves `*.lock` and `*.incomplete` files behind;
    the failure clears its own so that a retry starts clean."""
    residue = models_dir / ".cache" / "huggingface" / "download"
    residue.mkdir(parents=True)
    (residue / "coarse.pth.lock").write_bytes(b"")
    (residue / "coarse.pth.incomplete").write_bytes(b"partial")
    (residue / "other.pth.lock").write_bytes(b"")  # unrelated: untouched

    def offline(**kw):
        raise OSError("offline")

    _patch_hub(monkeypatch, offline)
    with pytest.raises(FileNotFoundError):
        registry._hub_download("r/r", "coarse.pth", models_dir / "coarse.pth")
    assert not (residue / "coarse.pth.lock").exists()
    assert not (residue / "coarse.pth.incomplete").exists()
    assert (residue / "other.pth.lock").exists()


def test_list_finetuned_local_discovery_offline(models_dir, monkeypatch):
    for name, files in [
        ("a", ["coarse.pth", "c2f.pth"]),
        ("b", ["coarse.vtpu", "c2f.vtpu"]),
        ("incomplete", ["coarse.pth"]),  # still listed: `&` means any-of
    ]:
        d = models_dir / "loras" / name
        d.mkdir(parents=True)
        for f in files:
            (d / f).write_bytes(b"x")
    _patch_hub(monkeypatch, lambda **kw: (_ for _ in ()).throw(OSError()))
    names = registry.list_finetuned()
    assert "a" in names and "b" in names
    assert registry.available_models()[-1] == "default"


def test_models_dir_from_the_environment(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", "from vampnet_tpu_torch import registry; "
         "print(registry.MODELS_DIR)"],
        cwd=registry.ROOT, env=dict(os.environ, VAMPNET_MODELS_DIR=str(tmp_path)),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)


def test_default_repo_reads_the_repo_file():
    assert registry._default_repo() == (registry.ROOT / "DEFAULT_HF_MODEL_REPO").read_text().strip()
