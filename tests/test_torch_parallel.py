"""Port parity: `vampnet_tpu_torch.parallel` (meshes, multi-process start-up,
partition specs) against `vampnet_tpu.parallel`.

Specs are compared leaf by leaf on one param tree: a JAX kernel (in, out) is
the port's weight (out, in), so its 2-d spec comes back transposed; every
other leaf keeps its name (kernel_q -> w_q, kernel_scale -> w_scale) and
its spec. `multihost_init` runs a gloo world of one in this process and a
world of two in spawned processes.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from test_torch_util import configs, lm_params_np
from vampnet_tpu.modules.quantize import quantize_lm_params
from vampnet_tpu.parallel import lm_param_specs as jlm_param_specs
from vampnet_tpu.parallel import make_mesh as jmake_mesh
from vampnet_tpu.parallel import mesh as jmesh_mod
from vampnet_tpu.parallel import opt_state_specs as jopt_state_specs
from vampnet_tpu.parallel import zero1_specs as jzero1_specs
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.parallel import (P, lm_param_specs, make_mesh, make_sp_mesh,
                                        opt_state_specs, tp_shard_state_dict, zero1_specs)
from vampnet_tpu_torch.parallel import mesh as mesh_mod

# ---------------------------------------------------------------- meshes


def test_make_mesh_shapes_match_jax():
    devs = ["cpu"] * 8
    m = make_mesh(n_devices=8, tp=2, devices=devs)
    jm = jmake_mesh(n_devices=8, tp=2)
    assert m.axis_names == jm.axis_names == ("dp", "tp")
    assert m.devices.shape == jm.devices.shape == (4, 2)
    assert m.shape == dict(jm.shape) == {"dp": 4, "tp": 2}
    assert all(d == torch.device("cpu") for d in m.device_list())
    sp = make_sp_mesh(n_devices=4, devices=devs)
    assert sp.axis_names == ("sp",) and sp.devices.shape == (4,) and sp.shape == {"sp": 4}
    with pytest.raises(AssertionError):
        make_mesh(n_devices=8, dp=3, tp=2, devices=devs)
    with pytest.raises(AssertionError):
        make_mesh(tp=3, devices=devs)
    # every visible card by default (the CPU alone where there is none);
    # "cuda" names card 0
    assert make_mesh().device_list() == mesh_mod.default_devices()
    if not torch.cuda.is_available():
        assert mesh_mod.default_devices() == [torch.device("cpu")]
    assert make_mesh(devices=["cuda"]).device_list() == [torch.device("cuda", 0)]


ENVS = [
    {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4", "RANK": "2"},
    {"MASTER_ADDR": "h", "RANK": "0"},  # the default port; no world size
    {"JAX_COORDINATOR_ADDRESS": "coord:1234", "JAX_NUM_PROCESSES": "16",
     "JAX_PROCESS_ID": "7", "MASTER_ADDR": "ignored", "WORLD_SIZE": "2", "RANK": "1"},
    {"JAX_PROCESS_ID": "3", "WORLD_SIZE": "5"},  # the dialects mix key by key
    {},
]


@pytest.mark.parametrize("env", ENVS)
def test_multihost_env_parsing_matches_jax(env):
    assert mesh_mod._multihost_args_from_env(env) == jmesh_mod._multihost_args_from_env(env)


def test_multihost_env_parsing_pins():
    args = mesh_mod._multihost_args_from_env(ENVS[0])
    assert args == {"coordinator_address": "10.0.0.1:29500", "num_processes": 4,
                    "process_id": 2}
    assert mesh_mod._multihost_args_from_env(ENVS[1])["coordinator_address"] == "h:8476"
    assert mesh_mod._multihost_args_from_env(ENVS[2]) == {
        "coordinator_address": "coord:1234", "num_processes": 16, "process_id": 7}


def test_multihost_init_world_of_one_idempotent_and_conflicts(monkeypatch):
    import torch.distributed as dist

    assert not dist.is_initialized()
    monkeypatch.setattr(mesh_mod, "_MULTIHOST_STATE", None)
    for k in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK",
              "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    try:
        assert mesh_mod.multihost_init(num_processes=1, process_id=0) == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        # a second call returns the live state without initialising again
        assert mesh_mod.multihost_init() == (0, 1)
        assert mesh_mod.multihost_init(num_processes=1, process_id=0) == (0, 1)
        with pytest.raises(RuntimeError, match="conflicting num_processes"):
            mesh_mod.multihost_init(num_processes=16)
        with pytest.raises(RuntimeError, match="conflicting process_id"):
            mesh_mod.multihost_init(process_id=3)
        # a group someone else started is adopted
        monkeypatch.setattr(mesh_mod, "_MULTIHOST_STATE", None)
        assert mesh_mod.multihost_init() == (0, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_main(rank, port, out_dir):
    from vampnet_tpu_torch.parallel import mesh as m

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank))
    got = m.multihost_init()
    import torch.distributed as dist

    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x)
    with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
        f.write(f"{got[0]} {got[1]} {x.item()}")
    dist.destroy_process_group()


def test_multihost_init_two_ranks_over_gloo(tmp_path):
    port = mesh_mod._free_port()
    torch.multiprocessing.spawn(_rank_main, args=(port, str(tmp_path)), nprocs=2, join=True)
    for rank in (0, 1):
        assert (tmp_path / f"rank{rank}").read_text() == f"{rank} 2 3.0"


# ---------------------------------------------------------------- specs


def _port_key(path):
    """A JAX param path -> the port's state-dict key and whether the leaf is
    a transposed kernel."""
    *site, leaf = path
    name = {"kernel": "weight", "kernel_q": "w_q", "kernel_scale": "w_scale"}.get(leaf, leaf)
    return ".".join((*site, name)), leaf in ("kernel", "kernel_q")


def _trees(kind):
    _, _, lms = configs("float32")
    jcfg, tcfg = lms["c2f"]
    if kind == "lora":
        jcfg = dataclasses.replace(jcfg, lora_r=2)
        tcfg = dataclasses.replace(tcfg, lora_r=2)
    tree = lm_params_np(jcfg, 3)
    if kind == "int8":
        tree = jax.tree.map(np.asarray, quantize_lm_params(jax.tree.map(jnp.asarray, tree)))
        tcfg = dataclasses.replace(tcfg, quantization="int8")
    return tree, convert.lm_state_dict_from_jax(tree, tcfg)


def _jax_specs_by_port_key(jspecs):
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        key, kernel = _port_key(tuple(str(getattr(k, "key", k)) for k in path))
        out[key] = tuple(reversed(tuple(spec))) if kernel and len(spec) == 2 else tuple(spec)
    return out


def _norm(spec, ndim):
    """A spec with its missing trailing entries written as None."""
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("kind", ["bf16", "int8", "lora"])
def test_lm_param_specs_match_jax_transposed(kind):
    tree, state = _trees(kind)
    want = _jax_specs_by_port_key(jlm_param_specs(tree))
    got = lm_param_specs(state)
    assert set(got) == set(want)
    for key, spec in got.items():
        assert isinstance(spec, P)
        nd = state[key].dim()
        assert _norm(spec, nd) == _norm(want[key], nd), key
    # the column sites split their weight's rows, the row sites its columns
    assert got["transformer.layers_0.self_attn.w_qs." + ("w_q" if kind == "int8" else "weight")] \
        == P("tp", None)
    assert got["transformer.layers_0.feed_forward.w_2." + ("w_q" if kind == "int8" else "weight")] \
        == P(None, "tp")
    if kind == "int8":
        assert got["transformer.layers_0.feed_forward.w_1.w_scale"] == P("tp")
        assert got["transformer.layers_0.self_attn.fc.w_scale"] == P()


@pytest.mark.parametrize("dp,min_size", [(2, 2 ** 14), (4, 2 ** 6), (3, 1), (1, 1)])
def test_zero1_specs_match_jax_transposed(dp, min_size):
    tree, state = _trees("bf16")
    jspecs = jlm_param_specs(tree)
    want = _jax_specs_by_port_key(jzero1_specs(jspecs, tree, dp, min_size=min_size))
    got = zero1_specs(lm_param_specs(state), state, dp, min_size=min_size)
    for key, spec in got.items():
        nd = state[key].dim()
        assert _norm(spec, nd) == _norm(want[key], nd), key
    if dp == 4:
        assert any("dp" in s for s in got.values())


def test_opt_state_specs_match_jax_transposed():
    tree, state = _trees("lora")
    zspecs = jzero1_specs(jlm_param_specs(tree), tree, 2, min_size=2 ** 6)
    jstate = {"count": np.zeros(()), "mu": tree, "nu": tree, "extra": [np.zeros((3, 4))]}
    jout = jopt_state_specs(jstate, zspecs)
    specs = zero1_specs(lm_param_specs(state), state, 2, min_size=2 ** 6)
    tstate = {"count": torch.zeros(()), "mu": state, "nu": dict(state),
              "extra": [torch.zeros(3, 4)]}
    got = opt_state_specs(tstate, specs)
    assert got["count"] == P() and got["extra"] == [P()]
    for moment in ("mu", "nu"):
        want = _jax_specs_by_port_key(jout[moment])
        assert set(got[moment]) == set(want)
        for key, spec in got[moment].items():
            nd = state[key].dim()
            assert _norm(spec, nd) == _norm(want[key], nd), (moment, key)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("row_parallel", [True, False])
def test_tp_shards_reassemble_the_layers(n, row_parallel):
    """Shard j holds block j of w_1's value half and of its gate half (the
    GEGLU pairs), block j of the heads, and the matching input columns of
    fc and w_2 (whole without row_parallel); concatenated they are the
    layer again."""
    _, state = _trees("lora")
    shards = [tp_shard_state_dict(state, j, n, row_parallel) for j in range(n)]
    pre = "transformer.layers_1."
    w1 = state[pre + "feed_forward.w_1.weight"]
    f = w1.shape[0] // 2
    for j, sh in enumerate(shards):
        assert "transformer.layers_0.self_attn.relative_attention_bias" not in sh
        assert not any(k.startswith(("embedding", "classifier")) for k in sh)
        got = sh[pre + "feed_forward.w_1.weight"]
        blk = f // n
        assert torch.equal(got, torch.cat([w1[j * blk:(j + 1) * blk],
                                           w1[f + j * blk:f + (j + 1) * blk]]))
    cat = lambda name, dim: torch.cat([sh[pre + name] for sh in shards], dim=dim)  # noqa: E731
    for site in ("w_qs", "w_ks", "w_vs"):
        assert torch.equal(cat(f"self_attn.{site}.weight", 0), state[pre + f"self_attn.{site}.weight"])
    # a column site's adapters: lora_a whole in every shard, lora_b split
    # with the outputs (w_1's in its GEGLU pairs)
    assert all(torch.equal(sh[pre + "self_attn.w_qs.lora_a"], state[pre + "self_attn.w_qs.lora_a"])
               for sh in shards)
    assert torch.equal(cat("self_attn.w_qs.lora_b", 1), state[pre + "self_attn.w_qs.lora_b"])
    b1 = state[pre + "feed_forward.w_1.lora_b"]
    assert torch.equal(shards[0][pre + "feed_forward.w_1.lora_b"],
                       torch.cat([b1[:, :f // n], b1[:, f:f + f // n]], dim=1))
    for site in ("self_attn.fc", "feed_forward.w_2"):
        w = state[pre + site + ".weight"]
        if row_parallel:
            assert torch.equal(cat(site + ".weight", 1), w)
            assert torch.equal(cat(site + ".lora_a", 0), state[pre + site + ".lora_a"])
        else:
            assert all(torch.equal(sh[pre + site + ".weight"], w) for sh in shards)
