"""Port parity: `.vtpu` checkpoint files (`vampnet_tpu_torch/checkpoints.py`
and its msgpack codec `_msgpack.py`) against the JAX package's
`checkpoints.py` and flax's serialization.

A file either package writes loads in the other with an equal config and
bit-identical leaves: fp32, bf16 (`ml_dtypes` on the JAX side,
`torch.bfloat16` in the port), int8-quantized and LoRA trees, and files
whose leaves flax chunks. Same trees give byte-identical files.
"""
import dataclasses

import flax.serialization
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_util import codec_params_np, configs, lm_params_np, to_jax
from vampnet_tpu import checkpoints as jckpt
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules.lora import lora_state_dict as jlora_state_dict
from vampnet_tpu.modules.quantize import quantize_lm_params
from vampnet_tpu_torch import _msgpack
from vampnet_tpu_torch import checkpoints as tckpt
from vampnet_tpu_torch.modules import LMConfig
from vampnet_tpu_torch.util import flatten_tree, unflatten_tree


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as a numpy array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_same_leaves(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for path in want:
        g, w = _bits(got[path]), _bits(want[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _torch_tree(tree):
    """A numpy tree as the port's tensors (bf16 leaves by their bits)."""
    def leaf(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return unflatten_tree({p: leaf(x) for p, x in flatten_tree(tree).items()})


def _lm_case(kind):
    """(JAX config, port config, numpy tree) for one tree kind."""
    jcfg = configs("float32")[2]["c2f"][0]
    if kind == "lora":
        jcfg = dataclasses.replace(jcfg, lora_r=2)
    tree = lm_params_np(jcfg, 3)
    if kind == "bf16":
        tree = unflatten_tree({p: x.astype(ml_dtypes.bfloat16)
                               for p, x in flatten_tree(tree).items()})
    elif kind == "int8":
        jcfg = dataclasses.replace(jcfg, quantization="int8")
        tree = unflatten_tree({p: np.asarray(x) for p, x in
                               flatten_tree(quantize_lm_params(to_jax(tree))).items()})
    return jcfg, LMConfig(**dataclasses.asdict(jcfg)), tree


KINDS = ["fp32", "bf16", "int8", "lora"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_lm_file_loads_in_port(tmp_path, kind):
    jcfg, tcfg, tree = _lm_case(kind)
    path = tmp_path / "lm.vtpu"
    jckpt.save_lm(path, jcfg, tree)
    cfg, params = tckpt.load_lm(path)
    assert isinstance(cfg, LMConfig) and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_same_leaves(params, tree)
    assert all(isinstance(x, torch.Tensor) for x in flatten_tree(params).values())


@pytest.mark.parametrize("kind", KINDS)
def test_port_lm_file_loads_in_jax_and_matches_its_bytes(tmp_path, kind):
    jcfg, tcfg, tree = _lm_case(kind)
    tckpt.save_lm(tmp_path / "port.vtpu", tcfg, _torch_tree(tree))
    cfg, params = jckpt.load_lm(tmp_path / "port.vtpu")
    assert cfg == jcfg
    _assert_same_leaves(params, tree)
    jckpt.save_lm(tmp_path / "jax.vtpu", jcfg, tree)
    assert (tmp_path / "port.vtpu").read_bytes() == (tmp_path / "jax.vtpu").read_bytes()


def test_codec_files_both_ways(tmp_path):
    jc, tc, _ = configs()
    tree = codec_params_np(jc, 4)
    jckpt.save_codec(tmp_path / "jax.vtpu", jc, tree)
    cfg, params = tckpt.load_codec(tmp_path / "jax.vtpu")
    assert cfg == tc and dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    _assert_same_leaves(params, tree)
    tckpt.save_codec(tmp_path / "port.vtpu", tc, params)
    jcfg, jparams = jckpt.load_codec(tmp_path / "port.vtpu")
    assert jcfg == jc
    _assert_same_leaves(jparams, tree)
    assert (tmp_path / "port.vtpu").read_bytes() == (tmp_path / "jax.vtpu").read_bytes()


def test_chunked_leaves_both_ways(tmp_path, monkeypatch):
    jcfg, tcfg, tree = _lm_case("fp32")
    # every leaf over 1 KB goes into flax's chunked form, 256 floats a chunk
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1024)
    jckpt.save_lm(tmp_path / "jax.vtpu", jcfg, tree)
    raw = (tmp_path / "jax.vtpu").read_bytes()
    assert raw.count(_msgpack.CHUNKED.encode()) > 10
    cfg, params = tckpt.load_lm(tmp_path / "jax.vtpu")
    assert cfg == tcfg
    _assert_same_leaves(params, tree)

    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 1024)
    tckpt.save_lm(tmp_path / "port.vtpu", tcfg, params)
    assert (tmp_path / "port.vtpu").read_bytes() == raw
    _assert_same_leaves(jckpt.load_lm(tmp_path / "port.vtpu")[1], tree)


def test_lora_overlay(tmp_path):
    """As `tests/test_convert.py::test_lora_overlay`: a base file and an
    adapter-only file; the merge replaces the adapters and nothing else."""
    jcfg, tcfg, tree = _lm_case("lora")
    tckpt.save_lm(tmp_path / "base.vtpu", tcfg, _torch_tree(tree))
    lora = {p: x + 1.0 for p, x in flatten_tree(jlora_state_dict(to_jax(tree))).items()}
    assert len(lora) == 2 * 5 * jcfg.n_layers  # w_qs, w_vs, fc, w_1, w_2
    jckpt.save_lora(tmp_path / "lora_jax.vtpu", unflatten_tree(lora))
    tckpt.save_lora(tmp_path / "lora_port.vtpu", _torch_tree(unflatten_tree(
        {p: np.asarray(x) for p, x in lora.items()})))
    for name in ("lora_jax.vtpu", "lora_port.vtpu"):
        _, merged = tckpt.load_lm(tmp_path / "base.vtpu", tmp_path / name)
        want = flatten_tree(tree)
        for path, x in flatten_tree(merged).items():
            if path[-1] in ("lora_a", "lora_b"):
                np.testing.assert_array_equal(x.numpy(), np.asarray(lora[path]))
            else:
                np.testing.assert_array_equal(x.numpy(), want[path])
        _, jmerged = jckpt.load_lm(tmp_path / "base.vtpu", tmp_path / name)
        _assert_same_leaves(merged, unflatten_tree(
            {p: np.asarray(x) for p, x in flatten_tree(jmerged).items()}))


def test_bad_magic_and_wrong_kind(tmp_path):
    jc, tc, lms = configs()
    (tmp_path / "junk.vtpu").write_bytes(b"VTPU0\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="neither a native .vtpu"):
        tckpt.load_lm(tmp_path / "junk.vtpu")
    with pytest.raises(ValueError, match="neither a native .vtpu"):
        tckpt.load_codec(tmp_path / "junk.vtpu")
    tckpt.save_codec(tmp_path / "codec.vtpu", tc, _torch_tree(codec_params_np(jc, 5)))
    with pytest.raises(ValueError, match="'vampnet_codec' checkpoint, not 'vampnet_lm'"):
        tckpt.load_lm(tmp_path / "codec.vtpu")
    jcfg = lms["coarse"][0]
    jckpt.save_lm(tmp_path / "lm.vtpu", jcfg, lm_params_np(jcfg, 6))
    with pytest.raises(ValueError, match="not 'vampnet_codec'"):
        tckpt.load_codec(tmp_path / "lm.vtpu")


def test_ctrl_dims_round_trip_as_in_jax(tmp_path):
    dims = (("loudness", 1), ("pitch", 3))
    jckpt.save_lm(tmp_path / "lm.vtpu", JLMConfig(ctrl_dims=dims), {})
    cfg, _ = tckpt.load_lm(tmp_path / "lm.vtpu")
    assert cfg == LMConfig(ctrl_dims=dims)
    tckpt.save_lm(tmp_path / "port.vtpu", cfg, {})
    assert jckpt.load_lm(tmp_path / "port.vtpu")[0] == JLMConfig(ctrl_dims=dims)


# ---------------------------------------------------------------- msgpack


def test_unknown_ext_type_and_dtype_raise():
    with pytest.raises(ValueError, match="ext type 5"):
        _msgpack.unpackb(msgpack.packb({"x": msgpack.ExtType(5, b"12345678")}))
    with pytest.raises(ValueError, match="complex64"):
        _msgpack.unpackb(flax.serialization.msgpack_serialize(
            {"x": np.ones(2, np.complex64)}))
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(flax.serialization.msgpack_serialize({"x": np.ones(3)})[:-2])


@pytest.mark.parametrize("n,code", [(6, 0xD8), (5, 0xC7), (300, 0xC8)])
def test_small_array_ext_forms(n, code):
    """An int8 (6,) array's payload is exactly 16 bytes: fixext 16; then
    ext 8 and ext 16."""
    x = np.arange(n, dtype=np.int8)
    raw = flax.serialization.msgpack_serialize({"x": x})
    assert raw[3] == code  # after the fixmap and the 1-char key's fixstr
    assert _msgpack.packb({"x": torch.from_numpy(x)}) == raw
    np.testing.assert_array_equal(_msgpack.unpackb(raw)["x"].numpy(), x)


_scalars = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=70) | st.binary(max_size=70))
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=40) | st.integers(-40, 40), inner, max_size=20),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_msgpack_round_trip(obj):
    raw = _msgpack.packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)  # the same bytes
    assert msgpack.unpackb(raw, raw=False, strict_map_key=False) == obj
    assert _msgpack.unpackb(raw) == obj


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False), max_size=20),
       st.lists(st.text(max_size=300), min_size=16, max_size=17),
       st.binary(min_size=256, max_size=70000))
def test_msgpack_reads_float32_and_wide_forms(floats, texts, blob):
    obj = {"f": floats, "t": texts, "b": blob, "m": {str(i): i for i in range(17)}}
    assert _msgpack.unpackb(msgpack.packb(obj, use_single_float=True)) == obj


_dtypes = st.sampled_from(["bool", "int8", "uint8", "int16", "int32", "int64", "float16",
                           "bfloat16", "float32", "float64"])


@settings(max_examples=80, deadline=None)
@given(_dtypes, st.lists(st.integers(0, 5), max_size=3), st.integers(0, 2 ** 32 - 1))
def test_array_leaves_match_flax(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    x = np.asarray(rng.standard_normal(shape) * 50).astype(np_dtype)
    raw = flax.serialization.msgpack_serialize({"x": x, "y": [1, "two"]})
    got = _msgpack.unpackb(raw)
    assert got["y"] == [1, "two"] and tuple(got["x"].shape) == tuple(shape)
    np.testing.assert_array_equal(_bits(got["x"]), _bits(x))
    assert _msgpack.packb(got) == raw
    back = flax.serialization.msgpack_restore(_msgpack.packb(got))
    np.testing.assert_array_equal(_bits(back["x"]), _bits(x))
