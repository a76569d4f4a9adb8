"""Counterpart of the repository's `__graft_entry__.py`:

  entry(device)               -> (fn, example_args): the flagship (coarse)
                                 LM's forward on one device.
  dryrun_multichip(n, device) -> an n-position ("dp", "tp") mesh on
                                 `device` (repeated: `["cpu"] * 8` stands for
                                 eight chips, as the JAX package's forced
                                 host devices do) running the FULL training
                                 step (codec encode -> masked-LM loss ->
                                 AdamW / Noam update) with dp, tp and ZeRO-1
                                 for one step at tiny shapes; then the
                                 pipeline placement (phase 2) and sequence
                                 parallel (phase 3) over the same positions.

    python -c "from vampnet_tpu_torch import graft_entry as g; g.dryrun_multichip(8, device='cpu')"

The device is the card unless the caller names another.
"""
from __future__ import annotations


def entry(device="cuda"):
    """(fn, (model, codes, codebooks)): fn(model, codes, codebooks) is the
    coarse LM's forward (20 layers, 20 heads, d=1280, 4 codebooks), the
    model's weights from the JAX package's initialisers at seed 0."""
    import torch

    from .modules import LMConfig, VampNetLM
    from .train.loop import init_lm_params
    from .util import resolve_device

    device = resolve_device(device)
    cfg = LMConfig.coarse()
    model = VampNetLM(cfg, device="meta").to_empty(device=device)
    init_lm_params(model, 0)
    b, t = 1, 256
    codes = torch.zeros((b, cfg.n_codebooks, t), dtype=torch.int64, device=device)
    codebooks = torch.zeros((cfg.n_codebooks, cfg.vocab_size, cfg.latent_dim), device=device)

    def fn(model, codes, codebooks):
        with torch.no_grad():
            return model.forward_codes(codes, codebooks)

    return fn, (model, codes, codebooks)


def _random_codec(codec, gen) -> None:
    """Random codec weights from `gen`: weight-norm directions normal, their
    norms in [0.3, 0.7] (the residual stacks' activations stay O(1)), snake
    alphas in [0.5, 1.5], small biases, normal codebooks."""
    import torch

    with torch.no_grad():
        for name, p in codec.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            u = torch.rand(p.shape, generator=gen, device=p.device)
            if leaf == "g":
                p.copy_(0.3 + 0.4 * u)
            elif leaf == "alpha":
                p.copy_(0.5 + u)
            else:
                x = torch.randn(p.shape, generator=gen, device=p.device)
                p.copy_(0.01 * x if leaf == "bias" else x)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The three phases (module docstring) with the JAX dry run's asserts;
    returns each phase's numbers."""
    import torch

    from .codec import LAC, CodecConfig
    from .interface import Interface
    from .modules import LMConfig, VampNetLM
    from .parallel import make_mesh
    from .train import make_optimizer
    from .train.loop import init_lm_params
    from .train.step import ShardedTrainState, make_sharded_train_step
    from .util import resolve_device

    device = resolve_device(device)
    positions = [device] * n_devices
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices=n_devices, tp=tp, devices=positions)
    dp = n_devices // tp

    codec_cfg = CodecConfig(
        sample_rate=16000, encoder_dim=16, encoder_rates=(2, 4, 4),
        decoder_dim=128, decoder_rates=(4, 4, 2), n_codebooks=4,
        codebook_size=64, codebook_dim=4,
    )
    lm_cfg = LMConfig(
        n_heads=4, n_layers=2, n_codebooks=4, n_conditioning_codebooks=0,
        latent_dim=4, embedding_dim=64, vocab_size=64, dropout=0.1,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    codec = LAC(codec_cfg, device=device).requires_grad_(False)
    _random_codec(codec, gen)
    lm = VampNetLM(lm_cfg, device="meta").to_empty(device=device)
    init_lm_params(lm, 2)

    b = max(dp, 2 * dp)  # batch divisible by dp
    t_audio = codec_cfg.hop_length * 16
    audio = torch.zeros((b, t_audio, 1), device=device)
    codebooks = codec.codebook_tables()[: lm_cfg.n_codebooks].detach()

    # ---- phase 1: the full training step over dp x tp with ZeRO-1 ----
    optimizer = make_optimizer(lm_cfg.embedding_dim, warmup=10)
    state = ShardedTrainState.create(lm_cfg, mesh, lm.state_dict(), optimizer)
    step_fn = make_sharded_train_step(lm_cfg, codec, optimizer)
    key = torch.Generator(device=device)
    key.manual_seed(0)
    new_state, metrics = step_fn(state, codebooks, audio, key)
    assert int(new_state.step) == 1
    assert float(metrics["loss"]) > 0.0
    out = {"train": dict(dp=dp, tp=tp, loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"]))}

    # ---- phase 2: pipeline-parallel inference placement ----
    # coarse on one slice of the positions, c2f and the decode codec on the
    # other; one two-stage generate through the stage boundary
    c2f_cfg = LMConfig(
        n_heads=4, n_layers=2, n_codebooks=4, n_conditioning_codebooks=2,
        latent_dim=4, embedding_dim=64, vocab_size=64, dropout=0.0,
    )
    c2f = VampNetLM(c2f_cfg, device="meta").to_empty(device=device)
    init_lm_params(c2f, 3)
    lm_params = lm.state_dict()
    iface = Interface.from_modules(
        codec_cfg, codec.state_dict(), lm_cfg, lm_params, c2f_cfg, c2f.state_dict(),
        coarse_chunk_size_s=0.2, coarse2fine_chunk_size_s=0.1, device=device)
    iface.shard_pipeline(n_coarse_devices=max(1, n_devices // 2), devices=positions)
    a, b_ = iface.placement.lms["coarse"].mesh, iface.placement.lms["c2f"].mesh
    # disjoint slices of the positions, together all of them
    assert a.size + b_.size == n_devices and a.size == max(1, n_devices // 2)
    z = torch.zeros((1, 4, 32), dtype=torch.int64, device=device)
    m = torch.ones_like(z)
    zc = iface.coarse_vamp(z, m, seed=0, _sampling_steps=2)
    zf = iface.coarse_to_fine(zc, mask=m, seed=1, _sampling_steps=2)
    assert tuple(zf.shape) == (1, 4, 32)
    assert bool((zf != c2f_cfg.mask_token).all())
    out["pipeline"] = dict(coarse_positions=a.size, c2f_positions=b_.size)

    # ---- phase 3: sequence-parallel inference ----
    # ring attention over the "sp" axis, reached from Interface.shard(sp=):
    # one chunk-free generate with the time axis split over all n positions
    iface_sp = Interface.from_modules(codec_cfg, codec.state_dict(), lm_cfg, lm_params,
                                      coarse_chunk_size_s=0.2, device=device)
    iface_sp.shard(sp=n_devices, devices=positions)
    assert iface_sp.placement.sp == n_devices
    z_long = torch.zeros((1, 4, 32 * n_devices), dtype=torch.int64, device=device)
    out_sp = iface_sp.coarse_vamp(z_long, torch.ones_like(z_long), seed=0, _sampling_steps=2)
    assert tuple(out_sp.shape) == tuple(z_long.shape)
    assert bool((out_sp != lm_cfg.mask_token).all())
    out["sp"] = dict(sp=n_devices, tokens=int(z_long.shape[-1]))
    return out
