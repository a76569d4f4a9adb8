"""Port parity: the file-based entry points (`Interface.from_checkpoints`,
`reload`, `load_finetuned`, `available_models`, `default`) against the JAX
package's `Interface(...)` on the same files.

The files hold tiny LoRA (rank 2) LMs with fp32 compute and the tiny codec
of `test_torch_util`, written by both packages (`.vtpu`) and as a loralib
adapter file (`.pth`), each LM with an adapter overlay. `vamp_e2e` runs the
deterministic settings of `tests/test_torch_e2e.py`, with a prompt in every
chunk, so the two packages must give identical tokens. The models directory
is a temporary one, and `huggingface_hub` is a fake that fails as an
offline hub does: nothing here reaches a network.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_e2e import DETERMINISTIC, _capture_decoded_codes, _signal
from test_torch_util import codec_params_np, configs, lm_params_np
from vampnet_tpu import checkpoints as jckpt
from vampnet_tpu import registry as jregistry
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu.interface import Interface as JInterface
from vampnet_tpu_torch import checkpoints as tckpt
from vampnet_tpu_torch import registry
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.codec import LAC, CodecConfig
from vampnet_tpu_torch.interface import Interface
from vampnet_tpu_torch.modules import LMConfig, VampNetLM
from vampnet_tpu_torch.train import make_optimizer, make_train_step
from vampnet_tpu_torch.util import flatten_tree, unflatten_tree

CHUNKS = dict(coarse_chunk_size_s=0.15, coarse2fine_chunk_size_s=0.05)


def _lora_cfgs():
    lms = configs("float32")[2]
    return {name: dataclasses.replace(lms[name][0], lora_r=2) for name in ("coarse", "c2f")}


def _shifted_adapters(tree, seed):
    rng = np.random.default_rng(seed)
    return unflatten_tree({p: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
                           for p, x in flatten_tree(tree).items()
                           if p[-1] in ("lora_a", "lora_b")})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    jc, tc, _ = configs()
    cfgs = _lora_cfgs()
    trees = {name: lm_params_np(cfg, 40 + i) for i, (name, cfg) in enumerate(cfgs.items())}
    tckpt.save_codec(root / "codec.vtpu", tc, codec_params_np(jc, 39))
    jckpt.save_lm(root / "coarse.vtpu", cfgs["coarse"], trees["coarse"])
    tckpt.save_lm(root / "c2f.vtpu", LMConfig(**dataclasses.asdict(cfgs["c2f"])),
                  trees["c2f"])
    jckpt.save_lora(root / "coarse_lora.vtpu", _shifted_adapters(trees["coarse"], 1))
    # a loralib adapter file: lora_A (r, in), lora_B (out, r)
    sd = {}
    for path, x in flatten_tree(_shifted_adapters(trees["c2f"], 2)).items():
        layer = path[1].split("_")[1]
        name = ".".join(("transformer", "layers", layer) + path[2:-1])
        leaf = "lora_A" if path[-1] == "lora_a" else "lora_B"
        sd[f"{name}.{leaf}"] = torch.from_numpy(x.T.copy())
    torch.save({"state_dict": sd, "metadata": {}}, root / "c2f_lora.pth")
    return root, trees


def _ckpts(root):
    return dict(coarse_ckpt=str(root / "coarse.vtpu"),
                coarse_lora_ckpt=str(root / "coarse_lora.vtpu"),
                coarse2fine_ckpt=str(root / "c2f.vtpu"),
                coarse2fine_lora_ckpt=str(root / "c2f_lora.pth"),
                codec_ckpt=str(root / "codec.vtpu"))


def _codes(iface, seen, key, signal_cls, seed=0):
    samples, sr = _signal()
    iface.vamp_e2e(signal_cls(samples, sr), batch_size=2, seed=seed, **DETERMINISTIC)
    return seen[key]


def test_from_checkpoints_tokens_identical_to_jax(files, monkeypatch):
    root, _ = files
    jiface = JInterface(**_ckpts(root), **CHUNKS)
    tiface = Interface.from_checkpoints(**_ckpts(root), device="cpu", **CHUNKS)
    assert tiface.coarse_path == root / "coarse.vtpu" and tiface.c2f_path == root / "c2f.vtpu"
    assert tiface.codec_path == root / "codec.vtpu"
    assert tiface.coarse.config.lora_r == tiface.c2f.config.lora_r == 2
    # the overlay reached the served weights (bf16, as the JAX _LoadedLM stores them)
    for name, lm in (("coarse", tiface.coarse), ("c2f", tiface.c2f)):
        jlm = getattr(jiface, name)
        for path, x in flatten_tree(jlm.params).items():
            key = ".".join(path[:-1]) + "." + {"kernel": "weight"}.get(path[-1], path[-1])
            got = lm.state_dict()[key]
            want = np.asarray(x.astype(np.float32))
            np.testing.assert_array_equal(got.float().numpy(), want.T if path[-1] == "kernel"
                                          else want, err_msg=str(path))
    seen = _capture_decoded_codes(monkeypatch)
    jcodes = _codes(jiface, seen, "jax", JAudioSignal)
    tcodes = _codes(tiface, seen, "torch", AudioSignal)
    assert tcodes.shape == jcodes.shape == (2, 4, 150)
    np.testing.assert_array_equal(tcodes, jcodes)


def _hub_offline(monkeypatch):
    mod = types.ModuleType("huggingface_hub")

    def offline(*a, **kw):
        raise OSError("offline")

    mod.hf_hub_download = offline
    mod.HfFileSystem = offline
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)


def test_reload_short_circuits_and_swaps(files, tmp_path):
    root, trees = files
    iface = Interface.from_checkpoints(**_ckpts(root), device="cpu", **CHUNKS)
    coarse, c2f = iface.coarse, iface.c2f
    iface.reload(coarse_ckpt=str(root / "coarse.vtpu"), c2f_ckpt=root / "c2f.vtpu")
    assert iface.coarse is coarse and iface.c2f is c2f  # equal paths: nothing loaded

    # another coarse checkpoint: rank 0, other weights
    cfg = configs("float32")[2]["coarse"][0]
    other = lm_params_np(cfg, 77)
    jckpt.save_lm(tmp_path / "other.vtpu", cfg, other)
    iface.quantize()
    assert iface.coarse.config.quantization == iface.c2f.config.quantization == "int8"
    iface.reload(coarse_ckpt=tmp_path / "other.vtpu")
    assert iface.coarse_path == tmp_path / "other.vtpu" and iface.c2f_path == root / "c2f.vtpu"
    assert iface.coarse.chunk_size_s == CHUNKS["coarse_chunk_size_s"]
    # the swapped LM takes its file's config: bf16 again, no adapters
    assert iface.coarse.config == LMConfig(**dataclasses.asdict(cfg))
    assert iface.c2f.config.quantization == "int8"
    w = iface.coarse.state_dict()["transformer.layers_1.feed_forward.w_2.weight"]
    want = other["transformer"]["layers_1"]["feed_forward"]["w_2"]["kernel"].T
    want = torch.from_numpy(want.copy()).to(torch.bfloat16)
    np.testing.assert_array_equal(w.float().numpy(), want.float().numpy())
    samples, sr = _signal()
    out = iface.vamp_e2e(AudioSignal(samples, sr), batch_size=2, seed=0, _sampling_steps=3)
    assert out.samples.shape == (2, 1, 150 * 32) and np.isfinite(out.samples).all()


@pytest.mark.parametrize("mode,swap", [("tp", "coarse"), ("sp", "coarse"), ("sp", "c2f"),
                                       ("pipeline", "c2f")])
def test_reload_under_a_placement(files, tmp_path, mode, swap):
    """A swapped LM arrives unplaced: under tp the other LM keeps its
    placement and the mesh stays; an sp placement that loses the coarse LM,
    or a pipeline that loses a stage, leaves the Interface unplaced; under
    sp a swapped c2f LM (never placed there) leaves the sp placement as it
    was."""
    root, _ = files
    iface = Interface.from_checkpoints(**_ckpts(root), device="cpu", **CHUNKS)
    place = {"tp": lambda: iface.shard(tp=1, devices=["cpu"] * 2),
             "sp": lambda: iface.shard(sp=2, devices=["cpu"] * 2),
             "pipeline": lambda: iface.shard_pipeline(devices=["cpu"] * 2)}[mode]
    place()
    before = iface.placement
    cfg = configs("float32")[2][swap][0]
    jckpt.save_lm(tmp_path / "other.vtpu", cfg, lm_params_np(cfg, 78))
    iface.reload(**{"coarse_ckpt" if swap == "coarse" else "c2f_ckpt": tmp_path / "other.vtpu"})
    after = iface.placement
    assert after.of(getattr(iface, swap)) is None
    if mode == "tp":
        assert after.mesh is before.mesh and after.lms == {"c2f": before.lms["c2f"]}
    elif mode == "sp" and swap == "c2f":
        assert after.sp == 2 and after.lms == before.lms
    else:
        assert (after.lms, after.mesh, after.sp, after.codec_decode) == ({}, None, 1, None)
    samples, sr = _signal()
    codes = iface.encode(AudioSignal(samples, sr))
    out = iface.vamp(codes, torch.ones_like(codes), seed=0, _sampling_steps=2)
    assert out.shape == codes.shape


def test_models_directory(files, tmp_path, monkeypatch):
    root, trees = files
    _hub_offline(monkeypatch)
    models = tmp_path / "models"
    monkeypatch.setattr(registry, "MODELS_DIR", models)
    monkeypatch.setattr(jregistry, "MODELS_DIR", models)
    (models / "loras" / "ft").mkdir(parents=True)
    for name in ("codec", "coarse", "c2f"):
        (models / f"{name}.vtpu").write_bytes((root / f"{name}.vtpu").read_bytes())
    for name, cfg in _lora_cfgs().items():  # a bf16 fine-tune with other adapters
        ft = flatten_tree(trees[name])
        ft.update(flatten_tree(_shifted_adapters(trees[name], 5)))
        tckpt.save_lm(models / "loras" / "ft" / f"{name}.vtpu",
                      LMConfig(**dataclasses.asdict(cfg)),
                      unflatten_tree({p: torch.from_numpy(x).to(torch.bfloat16)
                                      for p, x in ft.items()}))

    assert Interface.available_models() == JInterface.available_models() == ["ft", "default"]
    iface = Interface.default(device="cpu")
    assert (iface.coarse_path, iface.c2f_path, iface.codec_path) == (
        models / "coarse.vtpu", models / "c2f.vtpu", models / "codec.vtpu")
    iface.set_chunk_size(CHUNKS["coarse_chunk_size_s"])
    iface.c2f.chunk_size_s = CHUNKS["coarse2fine_chunk_size_s"]
    seen = _capture_decoded_codes(monkeypatch)
    base = _codes(iface, seen, "torch", AudioSignal).copy()

    iface.load_finetuned("ft")
    assert iface.coarse_path == models / "loras" / "ft" / "coarse.vtpu"
    assert iface.c2f_path == models / "loras" / "ft" / "c2f.vtpu"
    assert iface.coarse.chunk_size_s == CHUNKS["coarse_chunk_size_s"]
    lora_b = iface.c2f.state_dict()["transformer.layers_0.self_attn.fc.lora_b"]
    want = trees["c2f"]["transformer"]["layers_0"]["self_attn"]["fc"]["lora_b"]
    assert lora_b.dtype == torch.bfloat16 and not np.array_equal(lora_b.float().numpy(), want)
    tuned = _codes(iface, seen, "torch", AudioSignal)
    assert (tuned != base).any()  # the adapters moved the tokens

    iface.load_finetuned("default")
    assert iface.coarse_path == models / "coarse.vtpu"
    np.testing.assert_array_equal(_codes(iface, seen, "torch", AudioSignal), base)
    with pytest.raises(ValueError, match="not a valid model name"):
        iface.load_finetuned("nope")


def test_missing_model_raises_as_offline(tmp_path, monkeypatch):
    _hub_offline(monkeypatch)
    monkeypatch.setattr(registry, "MODELS_DIR", tmp_path)
    with pytest.raises(FileNotFoundError, match="codec.pth"):
        Interface.default(device="cpu")


def test_unported_options_raise_naming_their_item(files):
    root, _ = files
    # module 2: the config fields read from files (ctrl_dims is ported:
    # tests/test_torch_control.py)
    assert hasattr(VampNetLM(LMConfig(ctrl_dims=(("loudness", 1),)), device="meta"),
                   "ctrl_encoder")
    # remat is ported (ROADMAP Queue A item 5; tests/test_torch_train_options.py):
    # the step builds, and the stack recomputes its layers
    tiny = LMConfig(n_heads=2, n_layers=1, n_codebooks=2, latent_dim=4, embedding_dim=32,
                    vocab_size=32, remat=True)
    lm = VampNetLM(tiny, device="meta")
    assert callable(make_train_step(lm, None, make_optimizer(32)))
    assert lm.transformer.remat
    # the codec's compute options are ported (item 3;
    # tests/test_torch_codec_options.py): each builds with its schedule
    for kw, dtypes, impl in ((dict(compute_dtype="bfloat16"), ("bfloat16",) * 2, "xla"),
                             (dict(conv_impl="matmul"), ("float32",) * 2, "matmul"),
                             (dict(decoder_compute_dtype="bfloat16"), ("float32", "bfloat16"),
                              "xla")):
        codec = LAC(CodecConfig(**kw), device="meta")
        assert (str(codec.encoder.conv_in.dtype), str(codec.decoder.conv_in.dtype)) == \
            tuple(f"torch.{d}" for d in dtypes)
        assert codec.decoder.block_0.conv_t.impl == impl
        # the RVQ's projections stay fp32 under every option
        assert codec.quantizer.quantizer(0).in_proj.dtype == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        LAC(CodecConfig(compute_dtype="int8"), device="meta")
    # module 5: a control encoder in an upstream checkpoint is ported
    # (tests/test_torch_control.py); module 8: beat tracking is ported
    # (tests/test_torch_masks.py), and a wavebeat file that cannot be read
    # leaves the DP tracker
    ckpts = _ckpts(root)
    iface = Interface.from_checkpoints(**ckpts, wavebeat_ckpt=str(root / "wavebeat.pth"),
                                       device="cpu")
    assert iface.beat_tracker is not None and iface.beat_tracker.model is None
    # codec_overrides takes the runtime options, as the JAX Interface does
    iface = Interface.from_checkpoints(**ckpts, codec_overrides=dict(conv_impl="matmul"),
                                       device="cpu")
    assert iface.codec_config.conv_impl == "matmul"
    assert iface.codec.encoder.conv_in.impl == "matmul"
    iface = Interface.from_checkpoints(**ckpts, codec_overrides=dict(
        conv_impl="xla", compute_dtype="float32"), device="cpu")
    assert iface.codec_config.conv_impl == "xla"
