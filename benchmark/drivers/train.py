"""The coarse training step: the driver of `"kind": "train"` mixes.

Set-up builds the LM (fp32 parameters, the configuration's compute dtype
and dropout) and the frozen fp32 codec from weights made on the device from
the seed, the optimizer (`make_optimizer`: clip, AdamW, Noam) and the step
(`train.step.make_train_step`), and a pool of audio batches made from the
seed in pinned host memory, every row its own. Each step is driven as
`train/loop.py` drives it: the batch to the device, the generator reseeded
from the run's stream of step seeds, `train_step`, and the metrics read to
host floats (the tracker's read, which waits for the step).

The first `check_steps` steps run in set-up on distinct batches through the
same step object; they warm every shape and give the numbers the reference
follows (each step's loss, the first gradient as the optimizer took it, read
back from AdamW's first moment, and each leaf's change after them). The
window then continues the same state. It runs steps until `--seconds` have
passed and ends at the completion of the last one: the step time is the
window over the steps it holds. A traced run then profiles more steps.
"""
from __future__ import annotations

import time
from typing import Dict, List

from benchmark.harness.trace import now_ns, traced_seconds
from benchmark.harness.traffic import step_seeds, train_pool


class Training:
    def __init__(self, ctx, fault=None):
        import torch

        from benchmark.harness import weights
        from benchmark.reference import codec as ref_codec
        from benchmark.reference import lm as ref_lm
        from vampnet_tpu_torch.codec import LAC, CodecConfig
        from vampnet_tpu_torch.modules import LMConfig, VampNetLM
        from vampnet_tpu_torch.train import TrainState, make_optimizer, make_train_step

        self.ctx = ctx
        cfg, tr = ctx.cell.config, ctx.cell.traffic
        dev = ctx.device
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
        lm = VampNetLM(LMConfig(**cfg["lm"]), device="meta").to_empty(device=dev)
        lm.load_state_dict(lm_sd)
        del codec_sd, lm_sd
        ctx.log("models built")
        self.lm = lm.train()
        self.names = [n for n, p in lm.named_parameters() if p.requires_grad]
        o = cfg["optimizer"]
        self.optimizer = make_optimizer(lm.config.embedding_dim, factor=o["noam_factor"],
                                        warmup=o["noam_warmup"], weight_decay=o["weight_decay"],
                                        grad_clip=o["grad_clip"])
        self.state = TrainState.create(lm, self.optimizer)
        self.train_step = make_train_step(lm, self.codec, self.optimizer,
                                          label_smoothing=o["label_smoothing"])
        self.codebooks = self.codec.codebook_tables()[: lm.config.n_codebooks].detach()
        pool = train_pool(tr, ctx.seed, codec_cfg.sample_rate, codec_cfg.hop_length)
        self.hop = codec_cfg.hop_length
        self.pool = torch.from_numpy(pool)
        if dev.type == "cuda":
            self.pool = self.pool.pin_memory()
        self.seeds = step_seeds(ctx.seed, int(tr["max_steps"]))
        self.gen = torch.Generator(device=dev)
        self.trace = ctx.trace
        enc = self.codec.encode

        def encode(*a, **kw):
            with self.trace.span("codec.encode"):
                return enc(*a, **kw)

        self.codec.encode = encode
        if fault is not None:  # a planted fault (the benchmark's controls and tests)
            fault(self)
        self.i = 0
        self.losses: List[float] = []
        self.first_grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.steps_done: List[tuple] = []  # (start ns, end ns)
        ctx.log("batches made")
        self._check_steps(int(tr["check_steps"]))

    def step(self) -> Dict[str, float]:
        i = self.i
        self.i += 1
        audio = self.pool[i % self.pool.shape[0]].to(self.ctx.device, non_blocking=True)
        self.gen.manual_seed(self.seeds[i])
        t0 = now_ns()
        with self.trace.span("train.step"):
            self.state, metrics = self.train_step(self.state, self.codebooks, audio, self.gen)
        out = {k: float(v) for k, v in metrics.items()}
        self.steps_done.append((t0, now_ns()))
        if not all(map(lambda x: x == x and abs(x) != float("inf"), out.values())):
            raise FloatingPointError(f"step {i}: non-finite metrics {out}")
        return out

    def _check_steps(self, n: int) -> None:
        """The first n steps, with the readings the reference follows."""
        import torch

        params = self.state.params
        p0 = [p.detach().clone() for p in params]
        for k in range(n):
            m = self.step()
            self.losses.append(m["loss"])
            if k == 0:
                st = self.state.opt_state
                moments = [st.adamw.state[p]["exp_avg"] if st.adamw is not None else st.mu[j]
                           for j, p in enumerate(params)]
                norms = torch.stack([torch.linalg.vector_norm(m_.float()) for m_ in moments])
                self.first_grad = dict(zip(self.names, (norms / 0.1).tolist()))
        norms = torch.stack([torch.linalg.vector_norm(p.detach() - q) for p, q in zip(params, p0)])
        self.change = dict(zip(self.names, norms.tolist()))
        del p0

    def run_window(self, seconds: float, trace) -> float:
        """Steps until `seconds` have passed; the window ends with the last.
        A traced run then profiles the steps of `traced_seconds` more."""
        import torch

        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = len(self.steps_done)
        while time.perf_counter() - t0 < seconds:
            self.step()
        self.window = (t0, time.perf_counter())
        self.n_window = len(self.steps_done) - first
        if trace.enabled:
            trace.start()
            ts, ts_ns = time.perf_counter(), now_ns()
            first = len(self.steps_done)
            while time.perf_counter() - ts < traced_seconds(seconds):
                self.step()
            self.trace_window = (ts, time.perf_counter())
            self.traced_steps = len(self.steps_done) - first
            trace.mark(ts_ns, now_ns())
            trace.stop()
        return t0

    def attempted_failed(self):
        return self.n_window, 0

    def batch_shape(self):
        """(rows, tokens) of a step's batch."""
        return self.pool.shape[1], self.pool.shape[2] // self.hop

    def batch_samples(self) -> int:
        return self.pool.shape[2]

    def end_to_end(self) -> Dict[str, float]:
        return {"step_ms": 1e3 * (self.window[1] - self.window[0]) / self.n_window}

    def notes(self) -> Dict[str, float]:
        """The window's steps and the check steps' losses; in a traced run
        the step time while the profiler ran (against the window's, its
        host cost)."""
        out = {"steps": self.n_window, "check_losses": self.losses}
        if hasattr(self, "traced_steps"):
            out["traced_steps"] = self.traced_steps
            a, b = self.trace_window
            out["step_ms_traced"] = 1e3 * (b - a) / max(self.traced_steps, 1)
        return out

    def release(self):
        import gc

        import torch

        self.state = self.train_step = self.lm = self.codec = self.optimizer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def setup(ctx) -> Training:
    return Training(ctx)
