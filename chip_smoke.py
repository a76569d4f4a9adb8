"""Drive the PyTorch/CUDA port (`vampnet_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. print the card (`nvidia-smi`);
  2. build the CUDA kernels from `vampnet_tpu_torch/csrc` (nvcc, one process
     per source, started together) and print the build seconds;
  3. hold every kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it (coarse and c2f), and time kernel,
     plain version and, where one exists, a single PyTorch library call;
  4. serve ten full-width `Interface.vamp_e2e` requests (coarse 20 layers,
     c2f 16 layers, d=1280, the 44.1 kHz codec; random weights from a seed)
     and check their outputs and the kernels' launch counts;
  5. check the card's results against the CPU on small inputs: the coarse
     LM's logits (CPU in fp32) and the codec's codes and waveform.
Then it prints one JSON line with every kernel's numbers, the card line
again, and `{"ok": true, "device": ...}` as the last line. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""
import json
import math
import subprocess
import sys
import time

SEED = 0
REQUESTS = 10
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
# fp32 operations per logit in the sampler: 24 bisection steps x (compare,
# masked add of p, masked add of the count) + log-softmax, entropy and
# typicality (~10) + the temperature softmax and argmax (~6)
SAMPLER_OPS_PER_LOGIT = 24 * 3 + 16


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, flush_bytes=64 << 20):
    """Median device time of one call, L2 flushed before each (CUDA events)."""
    import torch

    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def check_attention(b, t, h, d, bias_dtype, gen):
    import torch
    import torch.nn.functional as F

    from vampnet_tpu_torch.ops.flash_attention import (
        attention_fwd_plain,
        flash_attention_with_bias,
    )

    dev = "cuda"
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.randn((h, t, t), generator=gen, device=dev).to(bias_dtype)
    out = flash_attention_with_bias(q, k, v, bias)
    ref = attention_fwd_plain(q, k, v, bias)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("attention kernel produced non-finite values")
    err = (out.float() - ref.float()).abs()
    # bf16 output; P enters PV as bf16 relative to a running max in the
    # kernel and to the row max in the plain version: a few bf16 ulps
    tol = 2e-2 + 2e-2 * ref.float().abs()
    if bool((err > tol).any()):
        raise AssertionError(f"attention kernel disagrees: max abs err {float(err.max())}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = bias[None]
    io_bytes = 4 * b * t * h * d * 2 + bias.numel() * bias.element_size()
    flops = 4 * b * h * t * t * d
    return dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: flash_attention_with_bias(q, k, v, bias)),
        plain_ms=time_ms(lambda: attention_fwd_plain(q, k, v, bias)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
        bound_ms=1e3 * max(io_bytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS),
        bound_by="bytes" if io_bytes / H100_BYTES_PER_S >= flops / H100_BF16_FLOPS else "operations",
    )


def check_sampler(b, flat, gen):
    import torch

    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits, fused_sample_plain

    dev = "cuda"
    logits = torch.randn((b, flat, 1024), generator=gen, device=dev) * 3.0
    keys = torch.randint(0, 2 ** 32, (b, 2), generator=gen, device=dev, dtype=torch.int64)
    temp = torch.full((b,), 1.0, device=dev)
    kw = dict(typical_filtering=True, typical_mass=0.15, typical_min_tokens=64)
    result = {}
    for mode, flag in (("greedy", 0.0), ("noisy", 1.0)):
        tok, prob = fused_sample_from_logits(keys, 5, logits, temp, flag, **kw)
        rtok, rprob = fused_sample_plain(keys, 5, logits, temp, flag, **kw)
        torch.cuda.synchronize()
        same = tok == rtok
        perr = (prob - rprob).abs()
        agree = same & (perr <= 1e-5)
        # the two sum in different orders, so where a bisection step's mass
        # sits within float rounding of typical_mass, or a token's
        # typicality within rounding of the threshold, the kept sets differ
        # by a token: the chosen token's probability (or, at an argmax tie,
        # the token) moves. Allow one such position in a thousand.
        ties = int((~agree).sum())
        if ties > tok.numel() // 1000:
            raise AssertionError(f"sampler {mode}: {ties} of {tok.numel()} positions differ "
                                 f"({int((~same).sum())} tokens)")
        result[f"{mode}_token_mismatches"] = int((~same).sum())
        result[f"{mode}_tie_positions"] = ties
        result[f"{mode}_max_abs_err"] = float(perr[same].max())
    io_bytes = logits.numel() * 4 + keys.numel() * 8 + b * flat * (8 + 4) + 3 * b * 4
    ops = logits.numel() * SAMPLER_OPS_PER_LOGIT
    result.update(
        max_abs_err=max(result["greedy_max_abs_err"], result["noisy_max_abs_err"]),
        ms=time_ms(lambda: fused_sample_from_logits(keys, 5, logits, temp, 1.0, **kw)),
        plain_ms=time_ms(lambda: fused_sample_plain(keys, 5, logits, temp, 1.0, **kw), reps=5),
        library_ms=None,
        bound_ms=1e3 * max(io_bytes / H100_BYTES_PER_S, ops / H100_FP32_FLOPS),
        bound_by="bytes" if io_bytes / H100_BYTES_PER_S >= ops / H100_FP32_FLOPS else "operations",
    )
    return result


def random_state(module, gen, std=0.02):
    """normal(0, std) for every parameter, drawn on the card from `gen`."""
    import torch

    return {k: torch.randn(v.shape, generator=gen, device=gen.device) * std
            for k, v in module.state_dict().items()}


def bench_signal(sr, seconds):
    """Two detuned partials and noise, as the JAX package's bench makes it."""
    import numpy as np

    from vampnet_tpu_torch.audio import AudioSignal

    t = np.arange(int(seconds * sr)) / sr
    wav = (0.4 * np.sin(2 * np.pi * 110 * t)
           + 0.2 * np.sin(2 * np.pi * 220 * t * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t)))
           + 0.05 * np.random.default_rng(SEED).standard_normal(len(t))).astype(np.float32)
    return AudioSignal(wav[None, None, :], sr)


def check_against_cpu(iface, gen):
    """Small inputs through the card's path and the CPU's plain path."""
    import dataclasses

    import torch

    from vampnet_tpu_torch.codec import LAC
    from vampnet_tpu_torch.modules import VampNetLM

    coarse = iface.coarse
    cfg32 = dataclasses.replace(coarse.config, compute_dtype="float32")
    cpu_lm = VampNetLM(cfg32, device="meta").to_empty(device="cpu")
    cpu_lm.load_state_dict(coarse.state_dict())
    codes = torch.randint(0, 1025, (1, cfg32.n_codebooks, 128), generator=gen, device="cuda")
    cbs = iface.codebooks[: cfg32.n_codebooks]
    with torch.inference_mode():
        got = coarse.forward_codes(codes, cbs).cpu()
        ref = cpu_lm.forward_codes(codes.cpu(), cbs.cpu())
    lm_err = float((got - ref).abs().max() / ref.abs().max())
    # bf16 projections through 20 layers against an fp32 reference
    if not lm_err < 5e-2:
        raise AssertionError(f"coarse logits on the card vs CPU fp32: rel err {lm_err}")

    cpu_codec = LAC(iface.codec_config, device="meta").to_empty(device="cpu")
    cpu_codec.load_state_dict(iface.codec.state_dict())
    sig = bench_signal(iface.codec_config.sample_rate, 0.5)
    audio = torch.from_numpy(sig.samples.transpose(0, 2, 1).copy())
    with torch.inference_mode():
        c_gpu = iface.codec.encode(audio.cuda()).cpu()
        c_cpu = cpu_codec.encode(audio)
        w_gpu = iface.codec.decode_codes(c_cpu.cuda()).cpu()
        w_cpu = cpu_codec.decode_codes(c_cpu)
    code_agree = float((c_gpu == c_cpu).float().mean())
    # fp32 with TF32 off on both sides: only a nearest-neighbour tie can flip
    if code_agree < 0.99:
        raise AssertionError(f"codec codes on the card vs CPU agree at {code_agree}")
    wav_err = float((w_gpu - w_cpu).abs().max() / w_cpu.abs().max().clamp(min=1e-12))
    if not wav_err < 1e-3:
        raise AssertionError(f"decoded waveform on the card vs CPU: rel err {wav_err}")
    return dict(lm_logits_rel_err=lm_err, codec_code_agreement=code_agree,
                codec_wave_rel_err=wav_err)


def profile_request(iface, sig, kw):
    """Device time by kernel over one request (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iface.vamp_e2e(sig, seed=99, **kw)
    wall = time.perf_counter() - t0
    # kernels only: the aten ops' rows repeat their kernels' device time
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile: wall {wall * 1e3:.1f} ms (profiler on), kernels busy {busy_ms:.1f} ms, "
          f"{sum(r[2] for r in rows)} kernel launches")
    for us, key, count in rows[:15]:
        print(f"profile:   {us / 1e3:9.2f} ms  x{count:<6d} {key[:90]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from vampnet_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the vampnet_tpu_torch package is not importable: {e}",
              file=sys.stderr)
        return 2
    from vampnet_tpu_torch.codec import LAC, CodecConfig
    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.ops.flash_attention import flash_attention_with_bias
    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path().name}")
    for line in build.build_logs().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"build: {line.strip()}")

    # ---- 3. kernels against their plain versions ----
    codec_cfg, coarse_cfg, c2f_cfg = CodecConfig(), LMConfig.coarse(), LMConfig.c2f()
    hop, sr = codec_cfg.hop_length, codec_cfg.sample_rate
    t_coarse, t_c2f = math.ceil(10 * sr / hop), math.ceil(3 * sr / hop)
    n_c2f_rows = 2 * math.ceil(t_coarse / t_c2f)
    d_head = coarse_cfg.embedding_dim // coarse_cfg.n_heads
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    checks = {
        ("attention_fwd", "coarse"): lambda: check_attention(
            2, t_coarse, coarse_cfg.n_heads, d_head, torch.bfloat16, gen),
        ("attention_fwd", "c2f"): lambda: check_attention(
            n_c2f_rows, t_c2f, c2f_cfg.n_heads, d_head, torch.bfloat16, gen),
        ("attention_fwd", "coarse_fp32_bias"): lambda: check_attention(
            2, t_coarse, coarse_cfg.n_heads, d_head, torch.float32, gen),
        ("sampler", "coarse"): lambda: check_sampler(
            2, t_coarse * coarse_cfg.n_predict_codebooks, gen),
        ("sampler", "c2f"): lambda: check_sampler(
            n_c2f_rows, t_c2f * c2f_cfg.n_predict_codebooks, gen),
    }
    results = {"attention_fwd": {}, "sampler": {}}
    for (name, shape), check in checks.items():
        results[name][shape] = check()
        print(f"kernel {name}[{shape}]: " + json.dumps(results[name][shape]))
    attn, samp = results["attention_fwd"], results["sampler"]

    # ---- 4. full-width requests ----
    t0 = time.perf_counter()
    iface = Interface.from_modules(
        codec_cfg, random_state(LAC(codec_cfg, device="meta"), gen),
        coarse_cfg, random_state(VampNetLM(coarse_cfg, device="meta"), gen),
        c2f_cfg, random_state(VampNetLM(c2f_cfg, device="meta"), gen),
        device="cuda",
    )
    torch.cuda.synchronize()
    print(f"setup: full-width interface built in {time.perf_counter() - t0:.1f} s")
    sig = bench_signal(sr, 10.0)
    kw = dict(batch_size=2, periodic_prompt=7, upper_codebook_mask=3, _sampling_steps=12,
              c2f_steps=2, transfer_dtype="int16")
    want_attn = 12 * coarse_cfg.n_layers + 2 * c2f_cfg.n_layers
    want_samp = 12 + 2
    n_samples = t_coarse * hop
    flash_attention_with_bias.launches = 0
    fused_sample_from_logits.launches = 0
    walls = []
    for i in range(REQUESTS):
        a0, s0 = flash_attention_with_bias.launches, fused_sample_from_logits.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = iface.vamp_e2e(sig, seed=SEED + i, **kw)
        wall = time.perf_counter() - t0
        walls.append(wall)
        da = flash_attention_with_bias.launches - a0
        ds = fused_sample_from_logits.launches - s0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"request {i}: wall {wall * 1e3:.1f} ms, peak {peak:.2f} GiB, "
              f"attention launches {da}, sampler launches {ds}, out {out.samples.shape}")
        if out.samples.shape != (2, 1, n_samples):
            raise AssertionError(f"output shape {out.samples.shape} != (2, 1, {n_samples})")
        if not np.isfinite(out.samples).all():
            raise AssertionError("non-finite output samples")
        if da != want_attn or ds != want_samp:
            raise AssertionError(f"launches per request: attention {da} (want {want_attn}), "
                                 f"sampler {ds} (want {want_samp})")
    launches = {"attention_fwd": flash_attention_with_bias.launches,
                "sampler": fused_sample_from_logits.launches}
    steady = sorted(walls[1:])  # the first request pays cuBLAS/cuDNN start-up
    quart = [steady[round(q * (len(steady) - 1))] * 1e3 for q in (0.25, 0.5, 0.75)]
    print(f"requests: {REQUESTS}, wall ms " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
          + f"; after the first: q1 {quart[0]:.1f}, median {quart[1]:.1f}, q3 {quart[2]:.1f}")

    # ---- 5. the card against the CPU on small inputs ----
    print("cpu check: " + json.dumps(check_against_cpu(iface, gen)))
    try:
        profile_request(iface, sig, kw)
    except Exception as e:  # a measurement aid only; the checks above decide
        print(f"profile: unavailable ({type(e).__name__}: {e})")

    def entry(name, source, replaces, res):
        main_shape = res["coarse"]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], **{k: main_shape[k] for k in keys},
            c2f={k: res["c2f"][k] for k in keys},
        )

    kernels = [
        entry("attention_fwd", "vampnet_tpu_torch/csrc/attention_fwd.cu",
              "vampnet_tpu/ops/flash_attention.py:120", attn),
        entry("sampler", "vampnet_tpu_torch/csrc/sampler.cu",
              "vampnet_tpu/ops/sampler_kernel.py:80", samp),
    ]
    print(f"total wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
