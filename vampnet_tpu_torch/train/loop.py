"""The training entry point (counterpart of `vampnet_tpu/train/loop.py`):

    python -m vampnet_tpu_torch.train.loop --args.load configs/vampnet.yml \
        --codec_ckpt models/codec.vtpu --save_path runs/coarse

reads the repo's yml configs (`config.py`: `$include`, scopes, CLI
overrides) and trains on one card: batches from `datasets.BatchLoader`
(numpy on the host, one pinned non-blocking copy a step), the step of
`step.py` (frozen-codec encode, mask, LM forward and backward, clip,
AdamW under the Noam schedule), validation every `val_freq` steps, audio
samples every `sample_freq` steps, checkpoints (`checkpoints.py`: latest,
best, <N>k) and resume from a saved tag (`resume: true`), the loader
skipping ahead to the saved step.

Randomness follows the JAX loop: every step draws its seed from
`np.random.default_rng(seed).integers(0, 2**31 - 1)` and validation batches
from `default_rng(seed + 1)`; each seeds the step's `torch.Generator` on the
card, so the data stream and the seed sequence are the JAX package's (the
draws from a seed are the port's own). The `prng` key names a JAX random
stream and has no counterpart: it is accepted and does nothing. New LMs
start from the JAX package's initialisers (lecun-normal kernels, unit norm
scales, zero biases, normal bucket tables and MASK latents, He-uniform
`lora_a`, zero `lora_b`), drawn from the seed.

Distributed training, as the JAX loop reads `mesh.dp` / `mesh.tp`: the
positions are `train(devices=)`, the stand-in for `jax.devices()` (by
default every visible card, or this process's card in a job of several),
and may repeat a device (`["cuda:0"] * 4`, four positions on one card). A
null `mesh.dp` is the largest divisor of the batch among the positions
(over every process) divided by tp. Past one position the state is a
`ShardedTrainState` over a ("dp", "tp") mesh (`make_sharded_train_step`:
tensor parallel within a dp group, the batch's rows over the groups, ZeRO-1
moments over dp). In a job of several processes (`main()` joins one when
`JAX_COORDINATOR_ADDRESS` or `MASTER_ADDR` is set, as under `torchrun`),
dp extends over the ranks: each rank loads its rows of every global batch
(`BatchLoader(shard=)`), the step and validation seeds are the same on
every rank, validation's metrics are the global batch's (so `is_best`
agrees), samples are computed by every rank, and rank 0 alone writes files
(checkpoints, metrics, samples, args.yml). With one position it is the
single-card `TrainState` of before.
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import config as cfglib
from .. import mask as pmask
from ..checkpoints import load_codec, load_lm
from ..codec import LAC
from ..convert import codec_state_dict_from_jax, lm_state_dict_from_jax
from ..interface import _load
from ..modules import LMConfig, VampNetLM
from ..parallel import make_mesh, make_train_mesh, process_count, process_index
from ..util import codebook_flatten, resolve_device, to_device
from .checkpoints import CheckpointManager
from .datasets import AudioDataset, AudioLoader, BatchLoader
from .step import (ShardedTrainState, TrainState, lora_filter, loss_and_metrics, make_optimizer,
                   make_sharded_train_step, make_train_step)
from .tracker import Tracker


def build_controller(args, codec_cfg):
    """Sketch2sound control conditioning (configs/lora/lora-s2s.yml:
    Sketch2SoundController.ctrl_keys), or None."""
    ctrl_keys = cfglib.bound(args, "Sketch2SoundController", "ctrl_keys", None)
    if not ctrl_keys:
        return None
    from ..control import Sketch2SoundController

    return Sketch2SoundController(ctrl_keys=list(ctrl_keys), hop_length=codec_cfg.hop_length,
                                  sample_rate=codec_cfg.sample_rate)


def build_lm_config(args, fine_tune: bool = False, controller=None) -> LMConfig:
    """The LM from the `VampNet.*` keys (with the JAX loop's defaults),
    `lora_r` on fine-tune runs and the controller's `ctrl_dims`."""
    g = lambda attr, default: cfglib.bound(args, "VampNet", attr, default)
    ctrl_dims = None
    if controller is not None:
        ctrl_dims = tuple(sorted(controller.ctrl_dims.items()))
    return LMConfig(
        n_heads=g("n_heads", 20),
        n_layers=g("n_layers", 16),
        n_codebooks=g("n_codebooks", 9),
        n_conditioning_codebooks=g("n_conditioning_codebooks", 0),
        latent_dim=g("latent_dim", 8),
        embedding_dim=g("embedding_dim", 1280),
        vocab_size=g("vocab_size", 1024),
        dropout=g("dropout", 0.1),
        lora_r=int(args.get("lora_r", 8)) if fine_tune else 0,
        remat=bool(g("remat", False)),
        ctrl_dims=ctrl_dims,
    )


def build_datasets(args, sample_rate: int):
    """(train, val) datasets from the `train/` and `val/` scoped keys."""

    def build(scope_name):
        with cfglib.scope(args, scope_name):
            loader = AudioLoader(**cfglib.bind_kwargs(
                args, "AudioLoader", sources=[], relative_path="", shuffle=True))
            return AudioDataset(loader, sample_rate, **cfglib.bind_kwargs(
                args, "AudioDataset", duration=10.0, loudness_cutoff=-30.0,
                n_examples=10_000_000, without_replacement=True))

    return build("train"), build("val")


def _encode_microbatch(args, dp: int):
    """The `encode_microbatch` knob: single-mesh only. At dp > 1 the groups
    already divide the encode batch (the memory this knob saves shrinks with
    it), so it is dropped, loudly (the user set it because the full-batch
    encode ran out of memory)."""
    mb = args.get("encode_microbatch")
    if not mb:
        return None
    if dp > 1:
        import warnings

        warnings.warn(
            f"encode_microbatch={mb} ignored: single-mesh only and dp={dp} "
            "already divides the per-chip encode batch"
        )
        return None
    return int(mb)


def _positions(device: torch.device, world: int) -> list:
    """The default mesh positions: every visible card (the CPU on the CPU),
    or in a job of several processes this process's own device."""
    if device.type == "cuda" and world == 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device.type == "cuda":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [device]


def build_mesh(args, batch_size: int, positions: list):
    """The ("dp", "tp") mesh from `mesh.dp` / `mesh.tp`, as the JAX loop
    builds it over `jax.devices()` (`positions` this process's, over every
    rank of the job)."""
    rank, world = process_index(), process_count()
    tp = int(args.get("mesh.tp", 1) or 1)
    n_global = len(positions) * world
    dp_req = args.get("mesh.dp")
    if dp_req is None:
        # the largest dp that divides the batch (unused positions dropped,
        # single-process only, as below)
        dp_req = n_global // tp
        while dp_req > 1 and batch_size % dp_req != 0:
            dp_req -= 1
    dp_req = int(dp_req)
    if world > 1 and dp_req * tp != n_global:
        raise ValueError(
            f"multi-host mesh must use every device: dp*tp = {dp_req}*{tp} "
            f"!= {n_global} global devices (pick batch_size/"
            "mesh.dp/mesh.tp so they multiply out)"
        )
    if world > 1:
        mesh = make_train_mesh(dp_req, tp, positions, (rank, world))
    else:
        mesh = make_mesh(n_devices=dp_req * tp, dp=dp_req, tp=tp, devices=positions)
    dp = mesh.shape["dp"]
    assert batch_size % dp == 0, f"batch_size {batch_size} not divisible by dp {dp}"
    return mesh


@torch.no_grad()
def init_lm_params(lm: VampNetLM, seed: int) -> None:
    """Fill every parameter of `lm` from the JAX package's initialisers
    (module docstring), drawn from a generator on the LM's device."""
    dev = next(lm.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in lm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "lora_b"):
            p.zero_()
        elif leaf == "lora_a":  # he_uniform, fan_in = in_features
            bound = math.sqrt(6.0 / p.shape[0])
            p.uniform_(-bound, bound, generator=gen)
        elif leaf == "weight" and p.dim() == 1:  # RMSNorm scale
            p.fill_(1.0)
        elif leaf == "weight":  # Dense (out, in): lecun_normal, truncated at 2 std
            std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
            torch.nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
        else:  # the bucket table and the MASK latents: normal(1)
            p.normal_(generator=gen)


def _build_lm(args, lm_cfg: LMConfig, fine_tune: bool, seed: int,
              device: torch.device) -> VampNetLM:
    """A fresh LM, or on a fine-tune run with `init_ckpt` the base
    checkpoint's weights (fresh adapters grafted on where its rank differs)."""
    lm = VampNetLM(lm_cfg, device="meta").to_empty(device=device)
    init_ckpt = args.get("init_ckpt")
    if not (fine_tune and init_ckpt):
        init_lm_params(lm, seed)
        return lm
    base_cfg, tree = load_lm(init_ckpt)
    base = lm_state_dict_from_jax(tree, lm_cfg)
    if base_cfg.lora_r != lm_cfg.lora_r:
        init_lm_params(lm, seed)
        sd = lm.state_dict()
        base = {k: base[k] if k in base else v for k, v in sd.items()}
    lm.load_state_dict(base, strict=True)
    return lm


def _floats(metrics: dict) -> dict:
    """Metric tensors -> floats in one host copy."""
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def make_eval_step(lm: VampNetLM, codec: LAC, codebooks: torch.Tensor,
                   label_smoothing: float = 0.1, controller=None):
    """eval_step(audio, generator) -> metrics: the training step's encode,
    r, mask and controls, the deterministic forward and the loss, no
    update."""
    cfg = lm.config
    ncc = cfg.n_conditioning_codebooks

    @torch.no_grad()
    def eval_step(audio: torch.Tensor, generator: torch.Generator) -> dict:
        z = codec.encode(audio)[:, : cfg.n_codebooks]
        t = z.shape[-1]
        r = torch.rand((z.shape[0],), generator=generator, device=z.device)
        mask = pmask.codebook_unmask(pmask.random(generator, z, r), ncc)
        z_masked, mask = pmask.apply_mask(z, mask, cfg.mask_token)
        ctrls = ctrl_masks = None
        if controller is not None:
            ctrls = {k: v[:, :t] for k, v in controller.extract(audio[..., 0]).items()}
            ctrl_masks = {k: v[:, :t] for k, v in
                          controller.random_mask(ctrls, r, generator).items()}
        logits = lm.forward_codes(z_masked, codebooks, ctrls=ctrls, ctrl_masks=ctrl_masks)
        _, metrics = loss_and_metrics(logits, z[:, ncc:, :], codebook_flatten(mask[:, ncc:, :]),
                                      r, label_smoothing=label_smoothing)
        return metrics

    return eval_step


def _next_batch(it, make_loader):
    try:
        return it, next(it)
    except StopIteration:
        it.close()
        it = iter(make_loader())
        return it, next(it)


def train(args: dict, seed: int = 0, device="cuda", stats: Optional[dict] = None,
          devices=None):
    """Train as the args say and return the final `TrainState` (one
    position) or `ShardedTrainState`. `devices`, the mesh positions of this
    process (module docstring), default to `device`'s kind: every visible
    card, or the CPU. With `stats`, a dict, the loop fills it with
    host-clock seconds: `step_s` (per step, from the batch's upload to its
    metrics on the host), `loader_wait_s` (per step, the host waiting for
    the loader), `save_s`, `val_s` and `sample_s` (per call)."""
    device = resolve_device(device)
    rank, world = process_index(), process_count()
    is_main = rank == 0
    save_path = Path(args.get("save_path", "ckpt"))
    fine_tune = bool(args.get("fine_tune", False))
    num_iters = int(args.get("num_iters", 1000))
    batch_size = int(args.get("batch_size", 8))
    val_freq = int(args.get("val_freq", 1000))
    sample_freq = int(args.get("sample_freq", 10000))
    save_iters = list(args.get("save_iters") or [])
    num_workers = int(args.get("num_workers", 4))
    grad_clip = float(args.get("grad_clip_val", 5.0))
    label_smoothing = float(args.get("CrossEntropyLoss.label_smoothing", 0.1))
    resume = bool(args.get("resume", False))
    tag = args.get("tag", "latest")
    positions = [resolve_device(d) for d in devices] if devices is not None \
        else _positions(device, world)
    mesh = build_mesh(args, batch_size, positions)
    dp = mesh.shape["dp"]
    sharded = mesh.size > 1 or world > 1
    device = mesh.device_list()[0]
    stats = {} if stats is None else stats
    for key in ("step_s", "loader_wait_s", "save_s", "val_s", "sample_s"):
        stats.setdefault(key, [])

    # ----- models -----
    codec_cfg, codec_tree = load_codec(args["codec_ckpt"])
    codec = _load(LAC(codec_cfg, device="meta"), codec_state_dict_from_jax(codec_tree, codec_cfg),
                  device, torch.float32)
    del codec_tree
    controller = build_controller(args, codec_cfg)
    lm_cfg = build_lm_config(args, fine_tune=fine_tune, controller=controller)
    if lm_cfg.vocab_size != codec_cfg.codebook_size:
        raise ValueError(f"vocab size {lm_cfg.vocab_size} must match the codec's codebook "
                         f"size {codec_cfg.codebook_size}")
    # the whole LM on the first position (each rank draws it alike), cut
    # over the mesh below
    lm = _build_lm(args, lm_cfg, fine_tune, seed, device)
    codebooks = codec.codebook_tables()[: lm_cfg.n_codebooks].detach()

    optimizer = make_optimizer(
        lm_cfg.embedding_dim,
        factor=float(args.get("NoamScheduler.factor", 2.0)),
        warmup=int(args.get("NoamScheduler.warmup", 10000)),
        grad_clip=grad_clip,
        lora_filter=lora_filter(lm) if fine_tune else None,
        state_dtype=args.get("AdamW.state_dtype"),
    )
    mb = _encode_microbatch(args, dp)  # serial encode sub-batches of this many rows
    if sharded:
        state = ShardedTrainState.create(lm_cfg, mesh, lm.state_dict(), optimizer)
        del lm
        lm = state.placement.groups[0]  # the samples' forward: dp group 0
        train_step = make_sharded_train_step(lm_cfg, codec, optimizer, label_smoothing,
                                             controller=controller, encode_microbatch=mb)

        def eval_step(audio, generator):
            return train_step.eval_step(state, codebooks, audio, generator)
    else:
        state = TrainState.create(lm, optimizer)
        train_step = make_train_step(lm, codec, optimizer, label_smoothing=label_smoothing,
                                     controller=controller, encode_microbatch=mb)
        eval_step = make_eval_step(lm, codec, codebooks, label_smoothing, controller)

    # ----- data, tracker, checkpoints, resume -----
    train_data, val_data = build_datasets(args, codec_cfg.sample_rate)
    tracker = Tracker(log_dir=str(save_path / "tb"), log_file=str(save_path / "metrics.jsonl"),
                      rank=rank)
    ckpt = CheckpointManager(save_path, is_main=is_main,
                             async_save=bool(args.get("save_async", False)))

    saved_latest = [None]  # the step the latest tag holds

    def save(name: str) -> None:
        t0 = time.perf_counter()
        ckpt.save(name, state, lm_cfg, tracker.state_dict(), fine_tune)
        stats["save_s"].append(time.perf_counter() - t0)
        if name == "latest":
            saved_latest[0] = state.step

    if resume and ckpt.has_tag(tag):
        tree, tracker_state = ckpt.restore(tag)
        state.load_state_dict(tree)
        del tree
        if tracker_state:
            tracker.load_state_dict(tracker_state)
        print(f"resumed from {save_path}/{tag} at step {state.step}", flush=True)
    if is_main:
        cfglib.dump_args(args, save_path / "args.yml")
    start_step = state.step
    # the seeds are the same on every rank: each draws the global batch's r
    # and masks alike and keeps its rows; only the data is per rank
    step_rng = np.random.default_rng(seed)
    # validation too: `is_best` decides the "best" save, which every rank
    # joins
    val_rng = np.random.default_rng(seed + 1)
    gen = torch.Generator(device=device)
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by {world} hosts")

    def make_loader(start_idx=0):
        return BatchLoader(train_data, batch_size, num_workers=num_workers, start_idx=start_idx,
                           shard=(rank, world))

    it = iter(make_loader(start_step * batch_size))
    t_last = time.time()
    try:
        for step_i in range(start_step, num_iters):
            t0 = time.perf_counter()
            it, batch = _next_batch(it, make_loader)
            t1 = time.perf_counter()
            audio = to_device(batch, device)
            gen.manual_seed(int(step_rng.integers(0, 2**31 - 1)))
            state, metrics = train_step(state, codebooks, audio, gen)
            tracker.step = step_i + 1
            tracker.log("train", _floats(metrics))
            stats["loader_wait_s"].append(t1 - t0)
            stats["step_s"].append(time.perf_counter() - t1)

            if (step_i + 1) % 50 == 0:
                dt = time.time() - t_last
                t_last = time.time()
                tracker.print_status("train", extra=f"{50 / dt:.2f} it/s")

            if sample_freq and (step_i + 1) % sample_freq == 0:
                t0 = time.perf_counter()
                save_samples(lm, codec, codebooks, audio, save_path, tracker, step_i + 1,
                             controller=controller, is_main=is_main)
                stats["sample_s"].append(time.perf_counter() - t0)

            if val_freq and (step_i + 1) % val_freq == 0:
                t0 = time.perf_counter()
                val_metrics = validate(eval_step, val_data, batch_size, val_rng, device,
                                       shard=(rank, world))
                stats["val_s"].append(time.perf_counter() - t0)
                tracker.log("val", val_metrics)
                tracker.print_status("val")
                save("latest")
                if tracker.is_best("val", "loss"):
                    save("best")
                if (step_i + 1) in save_iters:
                    save(f"{(step_i + 1) // 1000}k")
    finally:
        it.close()

    if saved_latest[0] != state.step:  # a validation may have saved this step
        save("latest")
    ckpt.wait_until_finished()
    tracker.close()
    return state


@torch.no_grad()
def save_samples(lm: VampNetLM, codec: LAC, codebooks: torch.Tensor, audio: torch.Tensor,
                 save_path, tracker: Tracker, step: int, n_save: int = 4,
                 controller=None, is_main: bool = True) -> None:
    """Audio demos: the reconstruction, the inpainting prompt (masked frames
    silent) and 12 MaskGIT steps filling the middle half, written as WAVs
    under samples/step_<step>/ and to TensorBoard where it is installed.
    `lm` is a `VampNetLM` or a dp group's `ShardedLM`. Every rank computes
    them; only `is_main` writes."""
    from ..audio import AudioSignal
    from ..sampling.generate import generate

    cfg = lm.config
    audio = audio[:n_save]
    z = codec.encode(audio)[:, : cfg.n_codebooks]
    t = z.shape[-1]
    mask = pmask.inpaint(z, int(t * 0.25), int(t * 0.25))
    mask = pmask.codebook_unmask(mask, cfg.n_conditioning_codebooks)
    z_masked, mask = pmask.apply_mask(z, mask, cfg.mask_token)
    ctrls = ctrl_masks = None
    if controller is not None:
        ctrls = {k: v[:, :t] for k, v in controller.extract(audio[..., 0]).items()}
        ctrl_masks = {k: v[:, :t] for k, v in controller.empty_mask(ctrls).items()}

    def forward(codes):
        return lm.forward_codes(codes, codebooks, ctrls=ctrls, ctrl_masks=ctrl_masks)

    gen = torch.Generator(device=z.device)
    gen.manual_seed(step)
    imputed = generate(forward, z_masked, mask, cfg.mask_token, generator=gen,
                       n_conditioning_codebooks=cfg.n_conditioning_codebooks,
                       sampling_steps=12)

    hop = codec.config.hop_length

    def decode(codes):
        wav = codec.decode_codes(torch.where(codes == cfg.mask_token, 0, codes))
        # silence the fully masked frames (upstream's decode does)
        all_masked = (codes == cfg.mask_token).all(dim=1)  # (b, t)
        b, tt = all_masked.shape
        wav = wav[:, : tt * hop].reshape(b, tt, hop)
        return (wav * (~all_masked)[:, :, None]).reshape(b, tt * hop)

    outs = {"reconstructed": decode(z), "inpainted_prompt": decode(z_masked),
            "inpainted_middle": decode(imputed)}
    if not is_main:
        return
    sample_dir = Path(save_path) / "samples" / f"step_{step}"
    for name, wavs in outs.items():
        wavs = wavs.float().cpu().numpy()
        out = sample_dir / name
        out.mkdir(parents=True, exist_ok=True)
        for i in range(wavs.shape[0]):
            AudioSignal(wavs[i][None, None, :], codec.config.sample_rate).write(out / f"{i}.wav")
            tracker.log_audio(f"{name}/{i}", wavs[i], codec.config.sample_rate, step)


def validate(eval_step, val_data, batch_size: int, rng: np.random.Generator, device,
             n_batches: int = 4, shard=(0, 1)) -> dict:
    """The mean of `eval_step`'s metrics over the first `n_batches` batches,
    each seeded from `rng`. In a job of several processes each rank loads
    its rows of the same global batches (`shard`) and `eval_step` returns
    the global batch's metrics, so every rank gets the same means."""
    out: dict = {}
    count = 0
    gen = torch.Generator(device=device)
    it = iter(BatchLoader(val_data, batch_size, num_workers=2, shard=shard))
    try:
        for batch in it:
            if count >= n_batches:
                break
            gen.manual_seed(int(rng.integers(0, 2**31 - 1)))
            m = _floats(eval_step(to_device(batch, device), gen))
            for k, v in m.items():
                out[k] = out.get(k, 0.0) + v
            count += 1
    finally:
        it.close()
    return {k: v / max(count, 1) for k, v in out.items()}


def main(argv=None):
    """The command line: `--args.load conf.yml` and `--Key value` overrides;
    `--device cpu` runs the plain PyTorch path (the card by default). With
    a coordinator in the environment (JAX's `JAX_COORDINATOR_ADDRESS` or
    torchrun's `MASTER_ADDR`) the process first joins the job
    (`multihost_init`), as the JAX loop's `main` does."""
    import os

    args = cfglib.parse_args(argv)
    if os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get("MASTER_ADDR"):
        from .. import parallel

        pid, n = parallel.multihost_init()
        print(f"[multihost] process {pid}/{n}")
    return train(args, device=args.get("device", "cuda"))


if __name__ == "__main__":
    main()
