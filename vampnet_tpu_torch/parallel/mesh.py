"""Device meshes and multi-process start-up (counterpart of
`vampnet_tpu/parallel/mesh.py`).

A `Mesh` is a numpy object array of `torch.device`s with named axes, the
surface of `jax.sharding.Mesh` that the serving code reads: `devices`,
`axis_names` and `shape` ({axis: size}). One process holds the whole mesh
and drives every device of it (a collective is a copy between devices and a
sum; a ring step is a `.to()` onto the next device). A device may appear
more than once: `["cuda:0"] * 4` is four mesh positions on one card, the
counterpart of the JAX package's virtual host devices, and runs every
sharded path, its kernels at their sharded shapes, on one card (or on the
CPU with `["cpu"] * 8`). Copies between two positions on one device are
free.

`multihost_init` joins a multi-process job (`torch.distributed`, NCCL on
CUDA, gloo on the CPU) for the cross-process axis of distributed training:
`make_train_mesh` lays a training job's ("dp", "tp") mesh over the ranks,
`process_index` / `process_count` stand for `jax.process_index` /
`jax.process_count`.
"""
from __future__ import annotations

import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


class Mesh:
    """Devices in an array with one named axis per dimension.

    `devices` are this process's positions. With `process=(rank, world)`
    (a training job of `world` processes) the first axis, "dp", extends over
    every process, rank-major as JAX orders the devices of its processes:
    `shape["dp"]` is the global count and this process holds rows
    [`dp_offset`, `dp_offset` + its rows)."""

    def __init__(self, devices, axis_names: Sequence[str], process: Tuple[int, int] = (0, 1)):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        arr.reshape(-1)[:] = flat
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.process = tuple(process)
        rank, world = self.process
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.shape[self.axis_names[0]] *= world
        self.dp_offset = rank * arr.shape[0]

    @property
    def size(self) -> int:
        return self.devices.size

    def device_list(self):
        """Every position's device, in row-major order."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list()]}, process={self.process})"


def default_devices():
    """Every visible CUDA device, or the CPU where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
              devices=None) -> Mesh:
    """A ("dp", "tp") mesh. Defaults: every device on dp, tp=1."""
    devices = list(default_devices() if devices is None else devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if dp is None:
        assert n % tp == 0, f"{n} devices not divisible by tp={tp}"
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != n_devices({n})"
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, tp), ("dp", "tp"))


def make_train_mesh(dp: int, tp: int, devices, process: Optional[Tuple[int, int]] = None) -> Mesh:
    """The ("dp", "tp") mesh of a training job: `dp` rows of `tp` positions
    over every process (`process=(rank, world)`, by default the live
    `torch.distributed` group's), this process's dp / world rows on its
    `devices`, which must number exactly dp * tp / world."""
    rank, world = (process_index(), process_count()) if process is None else process
    devices = list(devices)
    if dp % world:
        raise ValueError(f"dp={dp} does not divide over {world} processes")
    if len(devices) != dp // world * tp:
        raise ValueError(f"{len(devices)} positions in this process for dp={dp} x tp={tp} "
                         f"over {world} processes: want {dp // world * tp}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp // world, tp), ("dp", "tp"), process=(rank, world))


def process_index() -> int:
    """This process's rank in the job (`jax.process_index`): 0 outside one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the job (`jax.process_count`)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def dp_group():
    """The process group of the cross-process dp axis: every rank of the job
    (each process holds whole tp groups), i.e. the default group; None
    outside a job."""
    import torch.distributed as dist

    return dist.group.WORLD if process_count() > 1 else None


def make_sp_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A ("sp",) mesh for sequence-parallel (ring-attention) inference: the
    time axis is split over it and the key/value shards pass round the
    ring (`ops/ring_attention.py`)."""
    devices = list(default_devices() if devices is None else devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr, ("sp",))


_MULTIHOST_STATE: Optional[tuple] = None


def _multihost_args_from_env(env=None) -> dict:
    """Coordinator, world size and rank from the environment, in two
    dialects, the first found winning: JAX's `JAX_COORDINATOR_ADDRESS`,
    `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`, then torchrun's
    `MASTER_ADDR`[:`MASTER_PORT`], `WORLD_SIZE`, `RANK`. Missing keys stay
    None."""
    env = os.environ if env is None else env
    addr = env.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '8476')}"

    def _int(*keys):
        for k in keys:
            if k in env:
                return int(env[k])
        return None

    return {
        "coordinator_address": addr,
        "num_processes": _int("JAX_NUM_PROCESSES", "WORLD_SIZE"),
        "process_id": _int("JAX_PROCESS_ID", "RANK"),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None, process_id: Optional[int] = None,
                   local_device_ids=None, backend: Optional[str] = None) -> tuple:
    """Join the process group and return `(rank, world_size)`.

    Explicit arguments win; otherwise `_multihost_args_from_env` is read;
    with neither, the process is a world of one on a free localhost port.
    The backend is NCCL where CUDA is available and gloo otherwise, unless
    `backend` names one (gloo takes CUDA tensors in the all_reduce and
    broadcast that the trainer uses, so two ranks can share one card).
    `local_device_ids[0]` becomes this process's CUDA device, else torchrun's
    `LOCAL_RANK` where it is set.
    Idempotent: a second call returns the live `(rank, world_size)`, and
    raises if its explicit rank or world size disagrees with it."""
    global _MULTIHOST_STATE
    import torch.distributed as dist

    if _MULTIHOST_STATE is None and dist.is_available() and dist.is_initialized():
        _MULTIHOST_STATE = (dist.get_rank(), dist.get_world_size())
    if _MULTIHOST_STATE is not None:
        live_pid, live_n = _MULTIHOST_STATE
        if process_id is not None and process_id != live_pid:
            raise RuntimeError(
                f"multihost_init already initialized with process_id={live_pid}, "
                f"got conflicting process_id={process_id}")
        if num_processes is not None and num_processes != live_n:
            raise RuntimeError(
                f"multihost_init already initialized with num_processes={live_n}, "
                f"got conflicting num_processes={num_processes}")
        return _MULTIHOST_STATE
    env_args = _multihost_args_from_env()
    addr = coordinator_address or env_args["coordinator_address"] \
        or f"localhost:{_free_port()}"
    n = num_processes if num_processes is not None else env_args["num_processes"]
    pid = process_id if process_id is not None else env_args["process_id"]
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids is None and "LOCAL_RANK" in os.environ:
        local_device_ids = [int(os.environ["LOCAL_RANK"])]
    if local_device_ids is not None and torch.cuda.is_available():
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    dist.init_process_group(backend=backend, init_method=f"tcp://{addr}",
                            world_size=1 if n is None else n, rank=0 if pid is None else pid)
    _MULTIHOST_STATE = (dist.get_rank(), dist.get_world_size())
    return _MULTIHOST_STATE
