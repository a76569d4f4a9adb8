"""The coarse training step data-parallel over the cards of one host: the
driver of `"kind": "ddp"` mixes.

The run's process is rank 0 of a job of `ranks` processes, one a card. Its
set-up starts ranks 1 to `ranks` - 1 (`python3 -m benchmark.drivers.ddp
--rank r ...` from the checkout's root, each with torchrun's environment:
`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`), and every
rank joins the job as the trainer's `main()` does under torchrun
(`parallel.multihost_init`: NCCL on the cards, gloo on the CPU). Each rank
then builds what `train()` builds in such a job: the LM (fp32 parameters,
the configuration's compute dtype and dropout) and the frozen fp32 codec
from weights made on its card from the seed (every rank draws the same),
the ("dp", "tp") mesh of `dp` x `tp` positions over the ranks
(`train.loop.build_mesh`), the `ShardedTrainState` with ZeRO-1 moments over
dp, the optimizer (`make_optimizer`: clip, AdamW, Noam) and
`make_sharded_train_step`. The pool holds global batches of `batch` rows
made from the seed; each rank feeds its `batch / ranks` rows of each, as
`BatchLoader(shard=)` does, and seeds the step's generator from the run's
stream of step seeds, the same on every rank.

The first `check_steps` steps run in set-up, as in the single-card driver
(`drivers/train.py`), and give the numbers the reference follows: each
step's global loss, the first gradient as the optimizer took it (read back
from the gathered first moments, a collective) and each leaf's change after
them. The window then continues the same state. Before each step rank 0
broadcasts whether another follows, and every rank steps with it, so that
the ranks run the same steps; each step ends with the global batch's
metrics on the host. The step time is rank 0's window over the steps it
holds. A traced run then profiles rank 0's card for `traced_seconds` more.

A rank that exits with an error ends the run: rank 0 watches the others,
and a rank's process dies with rank 0's.
"""
from __future__ import annotations

import argparse
import atexit
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List

from benchmark.harness.trace import now_ns, traced_seconds
from benchmark.harness.traffic import step_seeds, train_pool


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """torchrun's variables for one rank of a job on this host."""
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
            "RANK": str(rank), "LOCAL_RANK": str(rank)}


class Workers:
    """Ranks 1 to world - 1 as child processes, watched from a thread: one
    that exits with an error ends this process too."""

    def __init__(self, ctx, world: int, port: int):
        root = ctx.cell.dir.parent
        self.procs = []
        for r in range(1, world):
            cmd = [sys.executable, "-m", "benchmark.drivers.ddp", "--rank", str(r),
                   "--parent", str(os.getpid()), "--workload", ctx.cell.name,
                   "--seed", str(ctx.seed)]
            self.procs.append(subprocess.Popen(cmd, cwd=str(root), stdout=sys.stderr,
                                               env=dict(os.environ, **rank_env(r, world, port))))
        self.joined = threading.Event()
        atexit.register(self.kill)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self.joined.is_set():
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0):
                    print(f"benchmark: rank {r} exited with {rc}; the run ends",
                          file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(1)
            time.sleep(0.5)

    def join(self, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        for r, p in enumerate(self.procs, 1):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc != 0:
                raise RuntimeError(f"rank {r} exited with {rc}")
        self.joined.set()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()


class DDPTraining:
    """One rank's part of the job (rank 0 records what the run reports)."""

    def __init__(self, ctx):
        import torch

        from benchmark.harness import weights
        from benchmark.reference import codec as ref_codec
        from benchmark.reference import lm as ref_lm
        from vampnet_tpu_torch import parallel
        from vampnet_tpu_torch.codec import LAC, CodecConfig
        from vampnet_tpu_torch.modules import LMConfig, VampNetLM
        from vampnet_tpu_torch.train import ShardedTrainState, make_optimizer
        from vampnet_tpu_torch.train.loop import build_mesh
        from vampnet_tpu_torch.train.step import make_sharded_train_step

        self.ctx = ctx
        cfg, tr = ctx.cell.config, ctx.cell.traffic
        self.rank, self.world = parallel.multihost_init()
        if self.world != int(tr["ranks"]):
            raise RuntimeError(f"a job of {self.world} ranks for a mix of {tr['ranks']}")
        dev = self.dev = (torch.device("cuda", torch.cuda.current_device())
                          if ctx.device.type == "cuda" else ctx.device)
        ctx.log(f"rank {self.rank} of {self.world} joined on {dev}")
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.seed)
        codec_cfg = CodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg["codec"].items()})
        codec_sd = weights.codec_state(ref_codec.param_shapes(ref_codec.config_from(cfg["codec"])),
                                       gen)
        lm_sd = weights.lm_state(ref_lm.param_shapes(ref_lm.config_from(cfg["lm"])), gen)
        codec = LAC(codec_cfg, device="meta").to_empty(device=dev)
        codec.load_state_dict(codec_sd)
        self.codec = codec.requires_grad_(False).eval()
        lm_cfg = LMConfig(**cfg["lm"])
        lm = VampNetLM(lm_cfg, device="meta").to_empty(device=dev)
        lm.load_state_dict(lm_sd)
        del codec_sd, lm_sd
        self.names = [n for n, p in lm.named_parameters() if p.requires_grad]
        self.p0 = ({n: p.detach().cpu() for n, p in lm.named_parameters() if p.requires_grad}
                   if self.rank == 0 else None)
        batch = int(tr["batch"])
        mesh = build_mesh({"mesh.dp": int(tr["dp"]), "mesh.tp": int(tr["tp"])}, batch, [dev])
        o = cfg["optimizer"]
        self.optimizer = make_optimizer(lm_cfg.embedding_dim, factor=o["noam_factor"],
                                        warmup=o["noam_warmup"], weight_decay=o["weight_decay"],
                                        grad_clip=o["grad_clip"])
        self.state = ShardedTrainState.create(lm_cfg, mesh, lm.state_dict(), self.optimizer)
        del lm
        self.trace = ctx.trace
        enc = self.codec.encode

        def encode(*a, **kw):
            with self.trace.span("codec.encode"):
                return enc(*a, **kw)

        self.codec.encode = encode
        self.train_step = make_sharded_train_step(lm_cfg, self.codec, self.optimizer,
                                                  label_smoothing=o["label_smoothing"])
        self.codebooks = self.codec.codebook_tables()[: lm_cfg.n_codebooks].detach()
        ctx.log("models built")
        rows = batch // self.world
        pool = train_pool(tr, ctx.seed, codec_cfg.sample_rate, codec_cfg.hop_length)
        self.pool = torch.from_numpy(
            pool[:, self.rank * rows:(self.rank + 1) * rows].copy())
        del pool
        if dev.type == "cuda":
            self.pool = self.pool.pin_memory()
        self.hop = codec_cfg.hop_length
        self.seeds = step_seeds(ctx.seed, int(tr["max_steps"]))
        self.gen = torch.Generator(device=dev)
        self.i = 0
        self.losses: List[float] = []
        self.first_grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.steps_done: List[tuple] = []  # (start ns, end ns)
        ctx.log("batches made")
        self._check_steps(int(tr["check_steps"]))

    def go(self, more: bool) -> bool:
        """Rank 0's word on whether another step follows, on every rank."""
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(more)], dtype=torch.int32, device=self.dev)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def step(self) -> Dict[str, float]:
        i = self.i
        self.i += 1
        audio = self.pool[i % self.pool.shape[0]].to(self.dev, non_blocking=True)
        self.gen.manual_seed(self.seeds[i])
        t0 = now_ns()
        with self.trace.span("train.step"):
            self.state, metrics = self.train_step(self.state, self.codebooks, audio, self.gen)
        out = {k: float(v) for k, v in metrics.items()}
        self.steps_done.append((t0, now_ns()))
        if not all(x == x and abs(x) != float("inf") for x in out.values()):
            raise FloatingPointError(f"step {i}: non-finite metrics {out}")
        return out

    def _check_steps(self, n: int) -> None:
        """The first n steps, with the readings the reference follows."""
        import torch

        for k in range(n):
            m = self.step()
            self.losses.append(m["loss"])
            if k == 0:
                mu, _nu = self.state.gathered_moments()  # every rank takes part
                if self.rank == 0:
                    self.first_grad = {name: float(torch.linalg.vector_norm(mu[name].float()))
                                       / 0.1 for name in self.names}
                del mu, _nu
        if self.rank == 0:
            now = self.state.params_state_dict()
            self.change = {name: float(torch.linalg.vector_norm(now[name] - self.p0[name]))
                           for name in self.names}
            del now
        self.p0 = None

    def follow(self) -> None:
        """A rank above 0: step while rank 0 says so, then leave the job."""
        while self.go(False):
            self.step()
        self.leave()

    def leave(self) -> None:
        import torch.distributed as dist

        dist.destroy_process_group()

    def run_window(self, seconds: float, trace) -> float:
        """Rank 0: steps until `seconds` have passed; the window ends with
        the last. A traced run then profiles the steps of `traced_seconds`
        more. Then the job ends."""
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = len(self.steps_done)
        while time.perf_counter() - t0 < seconds and self.go(True):
            self.step()
        self.window = (t0, time.perf_counter())
        self.n_window = len(self.steps_done) - first
        if trace.enabled:
            trace.start()
            ts, ts_ns = time.perf_counter(), now_ns()
            first = len(self.steps_done)
            while time.perf_counter() - ts < traced_seconds(seconds) and self.go(True):
                self.step()
            self.trace_window = (ts, time.perf_counter())
            self.traced_steps = len(self.steps_done) - first
            trace.mark(ts_ns, now_ns())
            self.go(False)
            trace.stop()
        else:
            self.go(False)
        self.leave()
        self.workers.join()
        return t0

    def attempted_failed(self):
        return self.n_window, 0

    def batch_shape(self):
        """(rows, tokens) of a rank's part of a step's batch."""
        return self.pool.shape[1], self.pool.shape[2] // self.hop

    def batch_samples(self) -> int:
        return self.pool.shape[2]

    def end_to_end(self) -> Dict[str, float]:
        return {"step_ms": 1e3 * (self.window[1] - self.window[0]) / self.n_window}

    def notes(self) -> Dict[str, float]:
        """The ranks, the window's steps and the check steps' global losses;
        in a traced run the step time while the profiler ran."""
        out = {"ranks": self.world, "steps": self.n_window, "check_losses": self.losses}
        if hasattr(self, "traced_steps"):
            out["traced_steps"] = self.traced_steps
            a, b = self.trace_window
            out["step_ms_traced"] = 1e3 * (b - a) / max(self.traced_steps, 1)
        return out

    def release(self):
        import gc

        import torch

        self.state = self.train_step = self.codec = self.optimizer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def setup(ctx) -> DDPTraining:
    """Rank 0: start the other ranks, then join the job with them."""
    world = int(ctx.cell.traffic["ranks"])
    port = _free_port()
    workers = Workers(ctx, world, port)
    os.environ.update(rank_env(0, world, port))
    tr = DDPTraining(ctx)
    tr.workers = workers
    return tr


def _die_with(parent: int) -> None:
    """This process gets SIGKILL when its parent exits (Linux's
    PR_SET_PDEATHSIG), and exits now if the parent is already gone."""
    import ctypes
    import signal

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def worker_main(argv=None) -> int:
    """A rank above 0, as `setup` starts it."""
    p = argparse.ArgumentParser(description="a rank of a ddp cell's job")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--parent", type=int, required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    _die_with(args.parent)
    from benchmark import run as bench

    bench._environment()
    import torch

    from benchmark.harness.cells import Cell
    from benchmark.harness.trace import Trace

    if torch.cuda.is_available():
        from vampnet_tpu_torch.ops import build

        build.library()
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    ctx = bench.Context(Cell(args.workload), args.seed, 0.0, Trace(False), device)
    DDPTraining(ctx).follow()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
