"""Drive the PyTorch/CUDA port (`vampnet_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (no failure is caught):
  1. print the card (`nvidia-smi`);
  2. build the CUDA kernels from `vampnet_tpu_torch/csrc` (nvcc, one process
     per source, started together) and print the build seconds and each
     kernel's registers and spills (the attention forward's 16 instances
     apart, the backward's 8 counted);
  3. hold every kernel against its plain PyTorch version on the card, at the
     shapes the serving path (coarse and c2f), the long-context chunks
     (t = 948, 1,034, 1,723, 2,048), the masked path and the coarse training
     step (b=8, and b=16 once; masked with key padding; b=1 at t=2,048) give
     it, and time kernel, plain version and, where one exists, a single
     PyTorch library call (the attention kernels also in TFLOP/s); the
     backward kernel, called twice on the same inputs, must repeat dk, dv
     and dbias bit for bit;
  4. serve full-width `Interface.vamp_e2e` requests (coarse 20 layers, c2f
     16 layers, d=1280, the 44.1 kHz codec; random weights from a seed) and
     check their outputs and the serving kernels' launch counts;
  5. train the full-width coarse LM (dropout 0.1, bf16 compute, fp32 params
     and Adam moments) for a few steps on 8 x 10 s of audio through the
     frozen codec, and check the loss, the grad norm, the parameters, the
     attention gradients and the training kernels' launch counts; profile
     one more step;
  6. check the card's results against the CPU on small inputs: the coarse
     LM's logits (CPU in fp32), the codec's codes and waveform, and a small
     training step's loss and gradients (CPU in fp32);
  7. profile one more request;
  8. serve long-context requests through the staged API, the Gradio app's
     sequence (encode -> build_mask -> set_chunk_size -> vamp -> decode):
     a 20 s coarse chunk on 20 s of audio (t = 1,723, the long forward K9)
     and an 11 s chunk on 10 s (t = 948); check launches and outputs;
     profile one;
 8b. serve through the continuous-batching engine and the stdlib web app
     (`serve_engine_and_webapp`, while the Interface is still bf16): 16
     requests on one 10 s signal; K1 and K10 held against their plain
     versions at an 8-request group's shapes; the requests one at a time
     twice (bit for bit) and all at once (batched, K1 272 and K10 14
     launches a group; each request's
     batched tokens within 0.02 of its solo ones, and its solo ones within
     0.02 of direct per-row-seed staged calls); one 8-request group
     profiled, and its per-row Philox draws alone; the card's idle share at
     pipeline_depth 1, 2, 2, 1; then 4
     concurrent web clients POSTing the 10 s WAV for two variations each,
     and one ?format=wav request; throughput, latency, busy time, peak
     memory and idle share printed beside the card;
 8c. the request options the JAX package takes (`check_sampler_top_k`,
     `staged_options`, `controls_full_width`, `train_controller`,
     `masks_and_beats`, `check_option_lms_against_cpu`): K10 with top_k
     held against its plain version at (4, 3,448) and (16, 2,590), top_k 1,
     8, 64 and 1,024, top-p off and 0.9, on tied logits, and timed at
     top_k=64 beside its time without; staged requests with top_k=64,
     cfg_guidance=3.0 and both (K1 272 and K10 14 each, profiled beside a
     plain one); a full-width coarse LM with sketch2sound controls (rmsq16
     and 36-bin chroma) extracted on the card and 12 MaskGIT steps with the
     controls' CFG (K1 240); 2 controller training steps at b=8 over 10 s
     (K4 and K8 20 each); the onset mask, beat masks through the DP tracker
     and a random-weight WaveBeat on the card, and the web app's "follow
     beat" preset served once; small LMs against the CPU (a control LM's
     logits, top_k and cfg_guidance tokens);
  9. run a full-width masked `TransformerStack` (b=8, t=862, key-padding
     `x_mask`) forward and backward (the masked training kernels, K5) and
     then forward without grad (the masked forward, K3); check a small
     masked stack and a small LM at t = 1,100 against the CPU;
 10. serve full-width requests with the fused-FFN option
     (`ffn_impl="fused"`, the same weights) and check that every layer's
     feed-forward went through the fused kernels and no w_1/w_2 product ran;
     profile one and print its busy time beside the bf16 request's;
 11. quantize the Interface to int8 (`Interface.quantize()`), serve
     full-width requests and check the w8a8 launch counts; profile one and
     print its busy time beside the bf16 request's (phase 7);
 12. check a small int8 LM and a small fused-FFN LM on the card against the
     CPU's plain path;
 13. serve the published architecture from checkpoint files that the run
     writes in a temporary directory (`serve_from_files`): full-width coarse
     and c2f LMs at LoRA rank 8 written as upstream's `.pth` files, the codec
     as `.vtpu`, loaded with `Interface.from_checkpoints` and served (the
     launch counts, every adapter site run, tokens that move when the
     adapters are zeroed); the converted LMs written as `.vtpu` and served
     to the same tokens; a models directory with a bf16 LoRA fine-tune
     (`available_models`, `Interface.default()`, `load_finetuned`, `reload`
     with the loaded paths); int8 requests after `quantize()`; a small LoRA
     LM against the CPU; both LoRA requests profiled; file sizes and load
     and write seconds printed;
 14. the trainer (`trainer_phase`), in a temporary directory (it fails if
     the disk has too little room): 16 synthetic 12 s WAVs and a
     random-weight codec file; the b=2 x 10 s encode and decode under each
     codec option (fp32/xla, fp32/matmul, bf16/xla, bf16/matmul, a bf16
     decoder: card ms, the share of codes that differ from fp32/xla, the
     decoded audio's relative error); `train.loop.train` from
     configs/vampnet.yml at b=8 (4 steps, validation every 2, samples at 4:
     K4 = K8 = 20 a step, K1 80 a validation and 240 a sample generation,
     K10 12), resumed to step 6; the trained LMs' `model.vtpu` served through
     `Interface.from_checkpoints` (K1 272, K10 14); 2 c2f steps from
     configs/c2f.yml (b=8 x 3 s, K4 = K8 = 16); 2 LoRA fine-tune steps from
     configs/lora/lora.yml on the coarse `.vtpu` (base weights bitwise
     unchanged, every adapter moved, lora.vtpu written); then coarse b=8
     steps with fp32 and bf16 Adam moments, remat at b=8 and b=16 (K4 40 a
     step) and `encode_microbatch=2`: step ms, peak memory, launches, the
     host's wait on the loader, checkpoint seconds and sizes, validation
     and sample ms;
 15. the entry points and the last single-card modules
     (`entry_points_phase`, in a temporary directory; it fails if the disk
     has too little room): K1 and K10 held against their plain versions at
     a one-chunk group's shapes (b=1 t=862 and (1, 3,448), timed) and at the
     c2f rows of groups of 1, 2 and 4 chunks; an upstream snapshot (codec,
     coarse and c2f at LoRA rank 8, a fine-tune, wavebeat, as `.pth`
     files) converted by `scripts.convert_reference` (stages 1, 2 and 4),
     the `.vtpu` files serving the `.pth` files' tokens (K1 272, K10 14);
     `vamp_microbatched` on 40 s (4 coarse chunks, seed array [1234]) at
     group_chunks 4, 2 and 1 (K1 272 and K10 14 a group; the coarse
     codebooks within SOLO_BATCHED_BOUND of the one-shot staged run; each
     run's wall and busy time); one coarse vamp with `save_debug_dumps` (12
     steps, the same tokens as without); `scripts.exp.experiment` on 2
     signals (baseline, reconstructed, coarse2fine, 1 sampling step) and
     `scripts.exp.eval` with the log-mel FAD and with a seeded VGGish on the
     card (its embeddings against the CPU's, its forward timed);
     `Interface.to("cpu")` and back, then a request; `hello.main` on the
     converted models directory and `assets/example.wav`.
Phase 3 also holds the w8a8 kernel (bit for bit) and the fused-FFN kernels
against their plain versions at the serving shapes, the w8a8 kernel also at
ragged shapes (m 1, 37, 300; k 16, 80, 2,560; n 8, 40, 5,128; bf16 and fp32
in and out), the fused FFN also at m 1, 37, 400, 1,724 x d 128, 640, 1,280,
2,560 and with a bf16 norm weight (two calls bit for bit), the sampler at the
settings the serving path does not reach (top-p, scalar and per row; no
typical filter; typical mass 0.9 with one token; temperature 0.5; rows of
equal logits; sharply peaked rows), and the attention
kernels at head dims 32 and 128 and with a bf16 bias. Then it prints one
JSON line with every kernel's numbers, the card line again, and
`{"ok": true, "device": ...}` as the last line. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""
import base64
import contextlib
import json
import math
import subprocess
import sys
import time

SEED = 0
REQUESTS = 5
LONG_REQUESTS = 3  # staged requests with a 20 s coarse chunk
OPTION_REQUESTS = 4  # per serving option (fused FFN, int8)
TRAIN_STEPS = 5
TRAIN_BATCH = 8
ENGINE_REQUESTS = 16  # concurrent requests through the serving engine
HTTP_CLIENTS = 4  # concurrent clients of the web app
SOLO_BATCHED_BOUND = 0.02  # share of a request's tokens that may differ batched vs solo
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
H100_INT8_OPS = 1979e12  # dense tensor-core int8
# fp32 operations per logit that the sampler's function needs: log-softmax,
# entropy and typicality (~10), 6 bisection steps over every logit x
# (compare, masked add of p, masked add of the count), and the compaction of
# the undecided band (~3). The other 18 steps and the softmax, noise and
# argmax run over the band and the kept tokens (tens a position), less than
# the logits' bytes take either way.
SAMPLER_OPS_PER_LOGIT = 10 + 6 * 3 + 3
SLEEP_CYCLES = 2_000_000  # about 1 ms of card time at 1.98 GHz


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, flush_bytes=64 << 20):
    """Median device time of one call, L2 flushed before each (CUDA events).
    The card sleeps for about a millisecond before each start event, so the
    host has enqueued the call's launches by the time the clock starts: the
    time is the card's alone, without the host's launch overhead (which
    `call_ms` includes)."""
    import torch

    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def call_ms(fn, reps=50):
    """Wall time per call over `reps` back-to-back calls that end in a
    synchronize (L2 warm): what an eager caller pays, the host's launch
    overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def key_padding_mask(b, t, valid, device="cuda"):
    """(b, t, t) bool, batch row i open on its first valid[i % len(valid)]
    keys (every query row keeps at least one key)."""
    import torch

    n = torch.tensor([valid[i % len(valid)] for i in range(b)], device=device)
    m = torch.arange(t, device=device)[None, None, :] < n[:, None, None]
    return m.expand(b, t, t).contiguous()


def random_mask(b, t, gen):
    """(b, t, t) bool, about a third of the keys blocked at random, the
    diagonal open (every query row keeps a key)."""
    import torch

    m = torch.rand((b, t, t), generator=gen, device=gen.device) > 1 / 3
    m[:, torch.arange(t), torch.arange(t)] = True
    return m


def check_attention(b, t, h, d, bias_dtype, gen, timed=True, mask=None):
    """The inference route of `flash_attention_with_bias` at (b, t, h, d)
    (K1; K3 with a mask; K9 past 1024) against its plain version; timed
    against one SDPA call with the bias (and the folded mask) as a float
    mask."""
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
    out = flash_attention_with_bias(q, k, v, bias, mask)
    ref = attention_fwd_plain(q, k, v, bias, mask=mask)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("attention kernel produced non-finite values")
    err = (out.float() - ref.float()).abs()
    # bf16 output; P enters PV as bf16 relative to a running max in the
    # kernel and to the row max in the plain version: a few bf16 ulps
    tol = 2e-2 + 2e-2 * ref.float().abs()
    if bool((err > tol).any()):
        raise AssertionError(f"attention kernel disagrees: max abs err {float(err.max())}")
    if not timed:
        return dict(max_abs_err=float(err.max()))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if mask is None:
        lib_mask = bias[None]
    else:  # the JAX wrapper's fold: -1e9 where blocked, a (b, h, t, t) tensor
        lib_mask = torch.where(mask[:, None], bias[None].to(q.dtype),
                               torch.tensor(-1e9, dtype=q.dtype, device=dev))
    # each input read once: q, k, v, o, the bias and the mask's bytes; the
    # products at the open entries only (what this mask's data needs)
    io_bytes = 4 * b * t * h * d * 2 + bias.numel() * bias.element_size()
    open_entries = b * t * t if mask is None else int(mask.sum())
    if mask is not None:
        io_bytes += mask.numel()
    flops = 4 * h * open_entries * d
    tb, tf = io_bytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    ms = time_ms(lambda: flash_attention_with_bias(q, k, v, bias, mask))
    return dict(
        max_abs_err=float(err.max()),
        ms=ms, tflops=flops / ms * 1e-9,
        call_ms=call_ms(lambda: flash_attention_with_bias(q, k, v, bias, mask)),
        plain_ms=time_ms(lambda: attention_fwd_plain(q, k, v, bias, mask=mask), reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                  attn_mask=lib_mask)),
        bound_ms=1e3 * max(tb, tf), bound_by="bytes" if tb >= tf else "operations",
        shape=f"b={b} t={t} h={h} d={d} bias {str(bias.dtype)[6:]}"
              + ("" if mask is None else f", mask open {open_entries / mask.numel():.3f}"),
    )


def rel_err(x, ref):
    """Relative Frobenius error of x against ref, in fp32."""
    return float((x.float() - ref.float()).norm() / ref.float().norm().clamp(min=1e-30))


def check_attention_train(b, t, h, d, gen, timed=True, bias_dtype=None, mask=None):
    """The training kernels at (b, t, h, d): forward-with-lse against its
    plain version, then the backward kernel against its plain version on the
    same (out, lse, do), and a second backward call on the same inputs: dk, dv
    and dbias must repeat bit for bit (whether dq does is reported). The bias
    is fp32 (training) or `bias_dtype`; with a `mask` the masked routes (K4
    over K3's scores, K5) run. Returns one result per kernel, keyed by the
    wrapper's name."""
    import torch
    import torch.nn.functional as F

    from vampnet_tpu_torch.ops import flash_attention as fa
    from vampnet_tpu_torch.ops.flash_attention import (
        LOG2E,
        attention_bwd_fused_plain,
        attention_delta,
        attention_fwd_lse_plain,
    )

    sfx = "" if mask is None else "_masked"
    names = [f"attention_fwd_lse{sfx}", f"attention_bwd_fused{sfx}"]
    fwd_k, bwd_k = (getattr(fa, n) for n in names)
    margs = () if mask is None else (mask,)
    dev = "cuda"
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    bias = torch.randn((h, t, t), generator=gen, device=dev).to(bias_dtype or torch.float32)
    out, lse = fwd_k(q, k, v, bias, *margs)
    ref_out, ref_lse = attention_fwd_lse_plain(q, k, v, bias, mask=mask)
    delta = attention_delta(out, do)
    bwd_args = (q, k, v, bias, lse, do, delta)
    grads = bwd_k(*bwd_args, *margs)
    again = bwd_k(*bwd_args, *margs)
    refs = attention_bwd_fused_plain(*bwd_args, mask)
    torch.cuda.synchronize()
    dq, dk, dv, dbias = grads
    for name, x in (("out", out), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv),
                    ("dbias", dbias)):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"training attention kernels: non-finite {name}")
    if dbias.dtype != bias.dtype or dq.shape != q.shape or dk.shape != k.shape:
        raise AssertionError(f"backward kernel: dbias {dbias.dtype} for a {bias.dtype} bias, "
                             f"dq {tuple(dq.shape)}, dk {tuple(dk.shape)}")
    out_err = (out.float() - ref_out.float()).abs()
    lse_err = float((lse - ref_lse).abs().max())
    # out: bf16, P rounded against a running max (as the inference kernel);
    # lse: fp32 sums of the same terms in another order
    if bool((out_err > 2e-2 + 2e-2 * ref_out.float().abs()).any()) or not lse_err <= 1e-3:
        raise AssertionError(f"forward-with-lse disagrees: out max abs err "
                             f"{float(out_err.max())}, lse max abs err {lse_err}")
    grad_names = ("dq", "dk", "dv", "dbias")
    errs = {n: rel_err(x, r) for n, x, r in zip(grad_names, grads, refs)}
    # bf16 products on both sides; the kernel rounds P and dS against the
    # same lse as the plain version, but sums in another order (dq across key
    # tiles by fp32 reduce-adds). Each limit sits a few times above the
    # readings of sound kernels on an H100 at b=8 and b=16 (dk 9.8e-5, dv
    # 9.1e-5, dq 2.8e-3, dbias 2.9e-7), so a kernel that lost its fp32
    # accumulation or stored dbias in bf16 fails
    limits = {"dq": 1e-2, "dk": 1e-3, "dv": 1e-3, "dbias": 1e-5}
    if bias.dtype == torch.bfloat16:
        # a bf16 dbias is rounded twice to bf16 after fp32 sums in another
        # order: where a rounding flips, that element moves by an ulp
        # (2^-8). The limit sits a few times above the sound kernels'
        # reading on an H100 (3.7e-5 to 4.0e-5 at b=2)
        limits["dbias"] = 2e-4
    if any(errs[n] > limits[n] for n in errs):
        raise AssertionError(f"backward kernel disagrees (rel Frobenius): {errs}")
    # dk, dv and dbias are summed in a fixed order: a repeat is bit for bit
    same = {n: torch.equal(x, y) for n, x, y in zip(grad_names, grads, again)}
    if not (same["dk"] and same["dv"] and same["dbias"]):
        raise AssertionError(f"backward kernel: a second call on the same inputs differs: {same}")
    fwd = dict(max_abs_err=float(out_err.max()), lse_max_abs_err=lse_err)
    bwd = dict(max_abs_err=max(float((x.float() - r.float()).abs().max())
                               for x, r in zip(grads, refs)),
               **{f"rel_err_{n}": errs[n] for n in grad_names},
               dq_bitwise_repeat=same["dq"])
    if not timed:
        return dict(zip(names, (fwd, bwd)))

    # bounds: each input read once, each output written once; one score-sized
    # product is 2 h d operations per (query, key) entry, counted at the open
    # entries only (what this mask's data needs); the mask's bytes are read
    act = b * t * h * d * 2  # one bf16 (b, t, h, d) tensor
    rows = b * h * t * 4  # one fp32 (b*h, t) tensor
    bias_bytes = h * t * t * bias.element_size()
    mask_bytes = 0 if mask is None else mask.numel()
    prod = 2 * h * d * (b * t * t if mask is None else int(mask.sum()))

    def bound(io_bytes, n_products):
        tb, tf = io_bytes / H100_BYTES_PER_S, n_products * prod / H100_BF16_FLOPS
        return dict(bound_ms=1e3 * max(tb, tf), bound_by="bytes" if tb >= tf else "operations")

    fwd.update(bound(4 * act + bias_bytes + mask_bytes + rows, 2))
    # q, k, v, do, bias, lse, delta read, dq, dk, dv, dbias written, 5 products
    bwd.update(bound(7 * act + 2 * bias_bytes + mask_bytes + 2 * rows, 5))
    fwd_ms = time_ms(lambda: fwd_k(q, k, v, bias, *margs))
    fwd.update(ms=fwd_ms, tflops=2 * prod / fwd_ms * 1e-9,
               call_ms=call_ms(lambda: fwd_k(q, k, v, bias, *margs)),
               plain_ms=time_ms(lambda: attention_fwd_lse_plain(q, k, v, bias, mask=mask),
                                reps=5))

    # the library yardstick for the forward with lse: SDPA's memory-efficient
    # kernel with compute_log_sumexp, which returns out and natural-log lse
    # rows. Its bias takes the query's dtype (bf16), broadcast over the batch
    # as SDPA broadcasts a mask, its rows padded to 16 elements as SDPA pads
    # them before it calls this kernel.
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    tp = -(-t // 16) * 16
    lib_bias = torch.zeros((1 if mask is None else b, h, t, tp), dtype=q.dtype, device=dev)
    lib_bias[..., :t] = bias if mask is None else torch.where(
        mask[:, None], bias.to(q.dtype)[None], torch.tensor(-1e9, dtype=q.dtype, device=dev))
    lib_bias = lib_bias[..., :t].expand(b, h, t, t)
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention

    def lib_fwd():
        return efficient(qt, kt, vt, lib_bias, True)[:2]

    lib_lse = lib_fwd()[1][:, :, :t].reshape(b * h, t) * LOG2E
    lib_err = float((lib_lse - ref_lse).abs().max())
    # the same rows up to the bias's rounding to bf16 (about 2^-9 of it)
    if not lib_err <= 5e-2:
        raise AssertionError(f"the library forward computes another lse: max abs err {lib_err}")
    fwd.update(library_ms=time_ms(lib_fwd), library_lse_max_abs_err=lib_err,
               library_note="aten._scaled_dot_product_efficient_attention with "
                            "compute_log_sumexp, bf16 bias")
    bwd_ms = time_ms(lambda: bwd_k(*bwd_args, *margs))
    bwd.update(ms=bwd_ms, tflops=5 * prod / bwd_ms * 1e-9,
               call_ms=call_ms(lambda: bwd_k(*bwd_args, *margs)),
               plain_ms=time_ms(lambda: attention_bwd_fused_plain(*bwd_args, mask), reps=5))

    # the library yardstick for the backward: autograd through one
    # scaled_dot_product_attention call, the bias expanded to a (b, h, t, t)
    # float mask that requires grad; the backward alone is timed
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    lib_mask = lib_bias.contiguous().requires_grad_()
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask)
    lib_do = do.transpose(1, 2)
    lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt, lib_mask), lib_do, retain_graph=True)
    if lib_grads[3] is None or not torch.isfinite(lib_grads[3].float()).all():
        raise AssertionError("the library backward gave no finite mask gradient")
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt, lib_mask), lib_do,
                                                 retain_graph=True), reps=5)
    bwd.update(library_ms=lib_ms,
               library_note="whole backward (dq, dk, dv, dmask (b, h, t, t)) of one SDPA call")
    print(f"kernel attention backward{sfx} b={b} t={t}: {bwd_ms:.4f} ms "
          f"({bwd['tflops']:.0f} TFLOP/s), bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}), "
          f"library backward {lib_ms:.4f} ms, dq bit for bit on a repeat: {same['dq']}")
    return dict(zip(names, (fwd, bwd)))


def sampler_agreement(label, keys, logits, temp, top_p=None, **kw):
    """The sampler kernel against its plain version on one input, greedy and
    noisy: the mismatching tokens, the positions that differ, and the worst
    probability error where the tokens agree."""
    import torch

    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits, fused_sample_plain

    result = {}
    for mode, flag in (("greedy", 0.0), ("noisy", 1.0)):
        tok, prob = fused_sample_from_logits(keys, 5, logits, temp, flag, top_p=top_p, **kw)
        rtok, rprob = fused_sample_plain(keys, 5, logits, temp, flag, top_p, **kw)
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
            raise AssertionError(f"sampler {label} {mode}: {ties} of {tok.numel()} positions "
                                 f"differ ({int((~same).sum())} tokens)")
        result[f"{mode}_token_mismatches"] = int((~same).sum())
        result[f"{mode}_tie_positions"] = ties
        result[f"{mode}_max_abs_err"] = float(perr[same].max())
    return result


def check_sampler(b, flat, gen, cases=False):
    """The sampler kernel at (b, flat) on the serving settings (typical
    filter, mass 0.15, at least 64 tokens) against its plain version, timed;
    with `cases`, also untimed at the settings and inputs the serving path
    does not reach: top-p (scalar and per row), no typical filter, a wide
    typical mass, temperature 0.5, rows of equal logits, sharply peaked
    rows."""
    import torch

    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits, fused_sample_plain

    dev = "cuda"
    logits = torch.randn((b, flat, 1024), generator=gen, device=dev) * 3.0
    keys = torch.randint(0, 2 ** 32, (b, 2), generator=gen, device=dev, dtype=torch.int64)
    temp = torch.full((b,), 1.0, device=dev)
    kw = dict(typical_filtering=True, typical_mass=0.15, typical_min_tokens=64)
    result = sampler_agreement("serving", keys, logits, temp, **kw)
    if cases:
        equal = torch.randn((b, flat, 1), generator=gen, device=dev).expand(b, flat, 1024)
        peaked = torch.randn((b, flat, 1024), generator=gen, device=dev) * 20.0
        top_p_rows = torch.linspace(0.5, 0.95, b, device=dev)
        for label, args, extra in (
            ("top_p_0.9", (logits, temp), dict(kw, use_top_p=True, top_p=0.9)),
            ("top_p_per_row", (logits, temp), dict(kw, use_top_p=True, top_p=top_p_rows)),
            ("no_typical_filter", (logits, temp), dict(kw, typical_filtering=False)),
            ("no_typical_filter_top_p_0.9", (logits, temp),
             dict(kw, typical_filtering=False, use_top_p=True, top_p=0.9)),
            ("typical_mass_0.9_min_1", (logits, temp),
             dict(kw, typical_mass=0.9, typical_min_tokens=1)),
            ("temperature_0.5", (logits, torch.full((b,), 0.5, device=dev)), kw),
            ("equal_logits", (equal.contiguous(), temp), kw),
            ("peaked_scale_20", (peaked, temp), kw),
        ):
            result[label] = sampler_agreement(label, keys, *args, **extra)
    io_bytes = logits.numel() * 4 + keys.numel() * 8 + b * flat * (8 + 4) + 3 * b * 4
    ops = logits.numel() * SAMPLER_OPS_PER_LOGIT
    result.update(
        max_abs_err=max(result["greedy_max_abs_err"], result["noisy_max_abs_err"]),
        ms=time_ms(lambda: fused_sample_from_logits(keys, 5, logits, temp, 1.0, **kw)),
        call_ms=call_ms(lambda: fused_sample_from_logits(keys, 5, logits, temp, 1.0, **kw)),
        plain_ms=time_ms(lambda: fused_sample_plain(keys, 5, logits, temp, 1.0, **kw), reps=5),
        library_ms=None,
        bound_ms=1e3 * max(io_bytes / H100_BYTES_PER_S, ops / H100_FP32_FLOPS),
        bound_by="bytes" if io_bytes / H100_BYTES_PER_S >= ops / H100_FP32_FLOPS else "operations",
    )
    return result


def check_engine_shapes(iface, t_tokens, group):
    """K1 and K10 against their plain versions (untimed) at the shapes and
    settings one engine group of `group` requests on `t_tokens` gives them:
    per LM, `group` x its chunks rows of one chunk, the bf16 T5 bias; the
    sampler with the requests' typical filter, temperatures 0.8 / 1.0 / 1.2
    by row, top-p off and at 0.9 (the phase's two static groups)."""
    import torch

    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    kw = dict(typical_filtering=True, typical_mass=0.15, typical_min_tokens=64)
    result = {}
    for name, lm in (("coarse", iface.coarse), ("c2f", iface.c2f)):
        cfg = lm.config
        chunk = iface.s2t(lm.chunk_size_s)
        rows = group * math.ceil(t_tokens / chunk)
        flat = chunk * cfg.n_predict_codebooks
        att = check_attention(rows, chunk, cfg.n_heads, cfg.embedding_dim // cfg.n_heads,
                              torch.bfloat16, gen, timed=False)
        result[f"attention_fwd_{name}"] = dict(att, shape=f"b={rows} t={chunk} h={cfg.n_heads}")
        logits = torch.randn((rows, flat, 1024), generator=gen, device=dev) * 3.0
        keys = torch.randint(0, 2 ** 32, (rows, 2), generator=gen, device=dev,
                             dtype=torch.int64)
        temp = torch.tensor([(0.8, 1.0, 1.2)[r % 3] for r in range(rows)], device=dev)
        top_p = torch.full((rows,), 0.9, device=dev)
        for label, extra in (("top_p_off", kw), ("top_p_0.9", dict(kw, use_top_p=True,
                                                                     top_p=top_p))):
            res = sampler_agreement(f"{name} engine {label}", keys, logits, temp, **extra)
            result[f"sampler_{name}_{label}"] = dict(
                res, shape=f"b={rows} flat={flat}",
                max_abs_err=max(res["greedy_max_abs_err"], res["noisy_max_abs_err"]))
    return result


def kernel_registers():
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ptxas's report in the build logs; a kernel is named by its function name
    and its mangled template arguments, as in `attention_bwd_kernel
    ILi128ELb0ELb0E` (D = 128, fp32 bias, no mask)."""
    import re

    from vampnet_tpu_torch.ops import build

    def short(mangled):
        # a source name is <length><name>; a hash's digits may run into the length
        for m in re.finditer(r"\d+", mangled):
            for i in range(m.start(), m.end()):
                word = mangled[m.end():m.end() + int(mangled[i:m.end()])]
                if word.endswith("_kernel"):
                    rest = mangled[m.end() + len(word):]
                    return f"{word} {rest.split('Ev')[0][:-1]}" if rest[:1] == "I" else word
        return mangled

    out, name = {}, None
    for line in build.build_logs().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def registers_of(fragment):
    """The ptxas readings of the kernels whose mangled name holds `fragment`."""
    return {k: v for k, v in kernel_registers().items() if fragment in k}


def check_w8a8(m, k, n, gen, timed=True):
    """The w8a8 kernel at (m, k) x (n, k): bit for bit against its plain
    version; times against `torch._int_mm` (the integer product alone) and a
    bf16 matmul of the same shape."""
    import torch
    import torch.nn.functional as F

    from vampnet_tpu_torch.ops.int8_matmul import (
        block_n,
        quantize_rows,
        w8a8_matmul,
        w8a8_matmul_plain,
    )

    dev = "cuda"
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-3
    out = w8a8_matmul(x, w_q, w_scale, out_dtype=torch.bfloat16)
    ref = w8a8_matmul_plain(x, w_q, w_scale, out_dtype=torch.bfloat16)
    out32 = w8a8_matmul(x, w_q, w_scale, out_dtype=torch.float32)
    ref32 = w8a8_matmul_plain(x, w_q, w_scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    err32 = float((out32 - ref32).abs().max())
    # exact: int32 accumulation and the same IEEE steps in the same order
    if not (torch.equal(out, ref) and torch.equal(out32, ref32)):
        raise AssertionError(f"w8a8 kernel at m={m} k={k} n={n} differs from its plain "
                             f"version: max abs err {err} (bf16 out), {err32} (fp32 out)")
    if not timed:
        return dict(max_abs_err=err)
    io_bytes = m * k * 2 + n * k + n * 4 + m * n * 2
    ops = 2 * m * k * n
    tb, tf = io_bytes / H100_BYTES_PER_S, ops / H100_INT8_OPS
    xq = quantize_rows(x)[0].contiguous()
    w_bf16 = torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
    return dict(
        max_abs_err=err, max_abs_err_fp32_out=err32, block_n=block_n(m, n),
        ms=time_ms(lambda: w8a8_matmul(x, w_q, w_scale)),
        call_ms=call_ms(lambda: w8a8_matmul(x, w_q, w_scale)),
        plain_ms=time_ms(lambda: w8a8_matmul_plain(x, w_q, w_scale), reps=5),
        library_ms=time_ms(lambda: torch._int_mm(xq, w_q.t())),
        library_note="torch._int_mm (cuBLASLt s8 GEMM): the integer product alone",
        bf16_matmul_ms=time_ms(lambda: F.linear(x, w_bf16)),
        bound_ms=1e3 * max(tb, tf), bound_by="bytes" if tb >= tf else "operations",
    )


def check_w8a8_ragged(gen):
    """The w8a8 kernel, untimed, at the ragged edges the serving shapes never
    reach (a row block of 1 or 37 rows, k short of one 128-byte stage, n
    short of or just past a tile), for bf16 and fp32 x and output: bit for
    bit against its plain version."""
    import torch

    from vampnet_tpu_torch.ops.int8_matmul import w8a8_matmul, w8a8_matmul_plain

    cases = 0
    for m in (1, 37, 300):
        for k in (16, 80, 2560):
            for n in (8, 40, 5128):
                w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                                    dtype=torch.int8)
                w_scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3
                x = torch.randn((m, k), generator=gen, device="cuda")
                for x_dtype in (torch.bfloat16, torch.float32):
                    for out_dtype in (torch.bfloat16, torch.float32):
                        xd = x.to(x_dtype)
                        out = w8a8_matmul(xd, w_q, w_scale, out_dtype=out_dtype)
                        ref = w8a8_matmul_plain(xd, w_q, w_scale, out_dtype=out_dtype)
                        torch.cuda.synchronize()
                        if out.dtype != out_dtype or not torch.equal(out, ref):
                            err = float((out.float() - ref.float()).abs().max())
                            raise AssertionError(
                                f"w8a8 kernel at m={m} k={k} n={n}, x {x_dtype}, out "
                                f"{out_dtype}, differs from its plain version: max abs err {err}")
                        cases += 1
    return dict(max_abs_err=0.0, cases=cases, m=[1, 37, 300], k=[16, 80, 2560],
                n=[8, 40, 5128], dtypes="x and out each bf16 and fp32")


def check_ffn(m, d, gen, timed=True, nw_bf16=False):
    """The fused-FFN kernels at (m, d) against their plain version, and two
    calls against each other (bit for bit: no atomics); timed against the
    unfused chain of the serving path (RMSNorm, linear, GELU, linear, add;
    no single PyTorch call computes the function) and against cuBLAS's two
    products alone."""
    import torch
    import torch.nn.functional as F

    from vampnet_tpu_torch.modules.activations import new_gelu
    from vampnet_tpu_torch.ops.ffn_kernel import block_n, fused_geglu_ffn, fused_geglu_ffn_plain

    dev = "cuda"
    x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
    nw = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    if nw_bf16:  # as the served LMs store it
        nw = nw.to(torch.bfloat16)
    w1 = (torch.randn((4 * d, d), generator=gen, device=dev) / d ** 0.5).to(torch.bfloat16)
    w2 = (torch.randn((d, 2 * d), generator=gen, device=dev) / (2 * d) ** 0.5).to(torch.bfloat16)
    out = fused_geglu_ffn(x, nw, w1, w2)
    again = fused_geglu_ffn(x, nw, w1, w2)
    ref = fused_geglu_ffn_plain(x, nw, w1, w2)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"fused FFN kernel produced non-finite values at m={m} d={d}")
    if not torch.equal(out, again):
        raise AssertionError(f"fused FFN kernel at m={m} d={d}: two calls differ")
    err = (out.float() - ref.float()).abs()
    # bf16 output; the kernel and the plain version round y and g to bf16 at
    # the same places, but sum in other orders, so a rounded y or g can move
    # by one bf16 ulp and the output with it
    tol = 2e-2 + 2e-2 * ref.float().abs()
    if bool((err > tol).any()):
        raise AssertionError(f"fused FFN kernel disagrees at m={m} d={d}: max abs err "
                             f"{float(err.max())}")
    if not timed:
        return dict(max_abs_err=float(err.max()))
    nwb = nw.to(torch.bfloat16)

    def unfused():
        xf = x.float()
        y = (nwb.float() * (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)))
        p1, p2 = F.linear(y.to(x.dtype), w1).chunk(2, dim=-1)
        return x + F.linear(p1 * new_gelu(p2), w2)

    h = torch.randn((m, 2 * d), generator=gen, device=dev).to(torch.bfloat16)
    bn_up, bn_down = block_n(m, d)
    row_tiles = (m + 127) // 128
    io_bytes = 2 * m * d * 2 + d * 4 + 4 * d * d * 2 + 2 * d * d * 2
    ops = 2 * m * d * 6 * d
    tb, tf = io_bytes / H100_BYTES_PER_S, ops / H100_BF16_FLOPS
    return dict(
        max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
        block_n_up=bn_up, tiles_up=row_tiles * -(-2 * d // bn_up),
        block_n_down=bn_down, tiles_down=row_tiles * -(-d // bn_down),
        ms=time_ms(lambda: fused_geglu_ffn(x, nw, w1, w2)),
        call_ms=call_ms(lambda: fused_geglu_ffn(x, nw, w1, w2)),
        plain_ms=time_ms(lambda: fused_geglu_ffn_plain(x, nw, w1, w2), reps=5),
        library_ms=None, unfused_chain_ms=time_ms(unfused),
        unfused_note="the serving path's unfused chain: RMSNorm, F.linear, GELU, F.linear, add",
        products_ms=time_ms(lambda: (F.linear(x, w1), F.linear(h, w2))),
        products_note="cuBLAS's bf16 F.linear for w_1 (m, d) x (4d, d) and w_2 (m, 2d) x (d, 2d)",
        bound_ms=1e3 * max(tb, tf), bound_by="bytes" if tb >= tf else "operations",
    )


def check_ffn_edges(gen):
    """The fused-FFN kernels, untimed, at ragged row counts and at other
    widths than the served d (2,560: past the served width and past the row
    pass's 2,048-wide batch), and with a bf16 norm weight: against the plain
    version, and bit for bit between two calls."""
    cases = {}
    for m in (1, 37, 400, 1724):
        for d in (128, 640, 1280, 2560):
            cases[f"m{m}_d{d}"] = check_ffn(m, d, gen, timed=False)["max_abs_err"]
    cases["m1724_d1280_bf16_norm_weight"] = check_ffn(1724, 1280, gen, timed=False,
                                                      nw_bf16=True)["max_abs_err"]
    return dict(max_abs_err=max(cases.values()), cases=cases)


def random_state(module, gen, fan_in=False):
    """Random weights drawn on `gen`'s device: normal(0, 0.02) for every
    parameter, or with `fan_in` weights that keep activations O(1) at any
    width (Dense weights normal / sqrt(fan-in), norm scales 1 + 0.1 normal,
    biases 0.02 normal, the bucket table and MASK latents normal). The small
    training check against the CPU takes the second: at d=128, 0.02 weights
    leave attention near uniform and the gradients it compares near zero."""
    import torch

    out = {}
    for k, v in module.state_dict().items():
        x = torch.randn(v.shape, generator=gen, device=gen.device)
        if not fan_in:
            x = 0.02 * x
        elif k.endswith(".weight") and v.dim() == 2:
            x = x / v.shape[1] ** 0.5
        elif k.endswith(".weight"):
            x = 1.0 + 0.1 * x
        elif k.endswith(".bias"):
            x = 0.02 * x
        out[k] = x
    return out


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


def profile(label, fn, totals=(), hits=None):
    """Device time by kernel over one call of fn (torch.profiler); also the
    time and launches of the kernels whose names hold each fragment in
    `totals`, which go into the dict `hits` where one is given as
    {fragment: (ms, launches)}. Returns (the busy time in ms, the kernel
    launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # kernels only: the aten ops' rows repeat their kernels' device time
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    n_launches = sum(r[2] for r in rows)
    if not rows:
        raise AssertionError(f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: wall {wall * 1e3:.1f} ms (profiler on), kernels busy "
          f"{busy_ms:.1f} ms, {n_launches} kernel launches")
    for us, key, count in rows[:15]:
        print(f"profile {label}:   {us / 1e3:9.2f} ms  x{count:<6d} {key[:90]}")
    for fragment in totals:
        hit = [r for r in rows if fragment in r[1]]
        ms, count = sum(r[0] for r in hit) / 1e3, sum(r[2] for r in hit)
        print(f"profile {label}: {ms:.2f} ms in {count} launches of {fragment}")
        if hits is not None:
            hits[fragment] = (ms, count)
    return busy_ms, n_launches


def train_audio(sr, hop, seconds, batch):
    """`batch` rows of `seconds` of noise at `sr`, cut to whole codec frames."""
    import numpy as np
    import torch

    n = math.ceil(seconds * sr / hop) * hop
    rng = np.random.default_rng(SEED)
    wav = (0.1 * rng.standard_normal((batch, n, 1))).astype(np.float32)
    return torch.from_numpy(wav).cuda()


def train_full_width(codec, codebooks, gen):
    """TRAIN_STEPS coarse training steps at full width; checks each step and
    the state after them. Returns (results, launches of the training kernels)."""
    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.ops.flash_attention import (
        attention_bwd_fused,
        attention_fwd_lse,
        flash_attention_with_bias,
    )
    from vampnet_tpu_torch.train import TrainState, make_optimizer, make_train_step

    cfg = LMConfig.coarse(dropout=0.1)
    lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
    lm.load_state_dict(random_state(lm, gen))
    opt = make_optimizer(cfg.embedding_dim)
    state = TrainState.create(lm, opt)
    step = make_train_step(lm, codec, opt)
    audio = train_audio(codec.config.sample_rate, codec.config.hop_length, 10.0, TRAIN_BATCH)
    cbs = codebooks[: cfg.n_codebooks]
    init = {k: v.clone() for k, v in lm.state_dict().items()}
    n_params = sum(p.numel() for p in state.params)
    print(f"train: coarse LM {n_params} params, batch {tuple(audio.shape)}, "
          f"dropout {cfg.dropout}, compute {cfg.compute_dtype}")
    dgen = torch.Generator(device="cuda")
    dgen.manual_seed(SEED)
    counters = {"attention_fwd_lse": attention_fwd_lse, "attention_bwd_fused": attention_bwd_fused}
    for c in (*counters.values(), flash_attention_with_bias):
        c.launches = 0
    walls, peaks = [], []
    for i in range(TRAIN_STEPS):
        before = {n: c.launches for n, c in counters.items()}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, cbs, audio, dgen)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        made = {n: c.launches - before[n] for n, c in counters.items()}
        print(f"train step {i}: wall {walls[-1] * 1e3:.1f} ms, peak {peaks[-1]:.2f} GiB, "
              f"loss {loss:.5f}, grad_norm {grad_norm:.5f}, launches {made}")
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise AssertionError(f"train step {i}: loss {loss}, grad_norm {grad_norm}")
        if any(m != cfg.n_layers for m in made.values()):
            raise AssertionError(f"train step {i}: launches {made}, want {cfg.n_layers} each")
    launches = {n: c.launches for n, c in counters.items()}
    if flash_attention_with_bias.launches:
        raise AssertionError("training launched the forward-only inference kernel")

    # the first moment is a decayed sum of the clipped gradients: exactly zero
    # for a parameter that never received one
    adam = state.opt_state.adamw.state
    mu = {n: adam[p]["exp_avg"] for n, p in lm.named_parameters() if p.requires_grad}
    for name, m in mu.items():
        attn = any(f".self_attn.{w}." in name for w in ("w_qs", "w_ks", "w_vs"))
        if (attn or name.endswith("relative_attention_bias")) and not bool((m != 0).any()):
            raise AssertionError(f"{name} received no gradient")
    if not all(bool(torch.isfinite(p).all()) for p in lm.parameters()):
        raise AssertionError("non-finite parameters after training")
    moved = sum(not torch.equal(v, init[k]) for k, v in lm.state_dict().items())
    if moved == 0:
        raise AssertionError("no parameter moved")
    steady = sorted(walls[1:])
    result = dict(step_ms=[round(w * 1e3, 1) for w in walls],
                  median_step_ms_after_first=steady[len(steady) // 2] * 1e3,
                  peak_gib=max(peaks), params_moved=moved, params=len(init),
                  launches_per_step={n: launches[n] // TRAIN_STEPS for n in launches})
    print("train: " + json.dumps(result))
    profile("train step", lambda: step(state, cbs, audio, dgen))
    return result, launches


def check_train_against_cpu(gen, device="cuda"):
    """A small training loss and its gradients: on `device` in bf16 compute
    (through the kernels on the card) against the CPU in fp32 (plain path),
    from one state, one batch and one r and mask."""
    import dataclasses

    import torch

    from vampnet_tpu_torch import mask as pmask
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.ops.flash_attention import attention_bwd_fused
    from vampnet_tpu_torch.train import loss_and_grads
    from vampnet_tpu_torch.util import codebook_flatten

    cfg = LMConfig(n_heads=2, n_layers=2, n_codebooks=4, embedding_dim=128, dropout=0.0)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_gen = torch.Generator().manual_seed(SEED)
    lm32 = VampNetLM(cfg32, device="cpu")
    lm32.load_state_dict(random_state(lm32, cpu_gen, fan_in=True))
    lm = VampNetLM(cfg, device="meta").to_empty(device=device)
    lm.load_state_dict(lm32.state_dict())
    z = torch.randint(0, cfg.vocab_size, (2, cfg.n_codebooks, 200), generator=cpu_gen)
    cbs = torch.randn((cfg.n_codebooks, cfg.vocab_size, cfg.latent_dim), generator=cpu_gen)
    r = torch.tensor([0.4, 0.7])
    z_masked, mask = pmask.apply_mask(z, pmask.random(cpu_gen, z, r), cfg.mask_token)
    batch = (z_masked, cbs, z, codebook_flatten(mask), r)
    n0 = attention_bwd_fused.launches
    loss, _, grads = loss_and_grads(lm, *(x.to(device) for x in batch))
    loss32, _, grads32 = loss_and_grads(lm32, *batch)
    if device == "cuda" and attention_bwd_fused.launches - n0 != cfg.n_layers:
        raise AssertionError("the small training step did not go through the kernels")
    loss_err = abs(float(loss) - float(loss32)) / abs(float(loss32))
    names = [n for n, p in lm.named_parameters() if p.requires_grad]
    errs = {n: rel_err(g.cpu(), g32) for n, g, g32 in zip(names, grads, grads32)}
    worst = max(errs, key=errs.get)
    # bf16 activations and products through 2 layers against fp32
    if not loss_err <= 1e-2 or errs[worst] > 5e-2:
        raise AssertionError(f"small training step vs CPU fp32: loss rel err {loss_err}, "
                             f"worst gradient {worst} rel err {errs[worst]}")
    return dict(train_loss_rel_err=loss_err, train_grad_worst=worst,
                train_grad_worst_rel_err=errs[worst])


def serve(label, request, n, counters, want, n_samples):
    """`n` full-width requests, `request(i)` returning request i's
    AudioSignal. Every counter in `counters` is set to 0 before the first and
    read after each; each request must make `want[name]` launches of each.
    Returns (summary, launches over the run)."""
    import numpy as np
    import torch

    for c in counters.values():
        c.launches = 0
    walls, peaks = [], []
    for i in range(n):
        before = {name: c.launches for name, c in counters.items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = request(i)
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        made = {name: c.launches - before[name] for name, c in counters.items()}
        print(f"{label} request {i}: wall {walls[-1] * 1e3:.1f} ms, peak {peaks[-1]:.2f} GiB, "
              f"launches {made}, out {out.samples.shape}")
        if out.samples.shape != (2, 1, n_samples):
            raise AssertionError(f"output shape {out.samples.shape} != (2, 1, {n_samples})")
        if not np.isfinite(out.samples).all():
            raise AssertionError("non-finite output samples")
        if made != want:
            raise AssertionError(f"{label}: launches per request {made}, want {want}")
    launches = {name: c.launches for name, c in counters.items()}
    # the first request pays cuBLAS/cuDNN start-up (a single request stands alone)
    steady = sorted(walls[1:] or walls)
    quart = [steady[round(q * (len(steady) - 1))] * 1e3 for q in (0.25, 0.5, 0.75)]
    summary = dict(wall_ms=[round(w * 1e3, 1) for w in walls], q1_ms=quart[0],
                   median_ms_after_first=quart[1], q3_ms=quart[2], peak_gib=max(peaks),
                   launches_per_request=want)
    print(f"{label} requests: " + json.dumps(summary))
    return summary, launches


def check_options_against_cpu(gen):
    """A small int8 LM and a small fused-FFN LM: the card (bf16 compute,
    through the w8a8 and fused-FFN kernels) against the CPU (fp32 compute,
    the plain versions), from one set of weights and one input."""
    import dataclasses

    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.modules.quantize import quantize_lm_state_dict
    from vampnet_tpu_torch.ops.ffn_kernel import fused_geglu_ffn
    from vampnet_tpu_torch.ops.int8_matmul import w8a8_matmul

    base = LMConfig(n_heads=2, n_layers=2, n_codebooks=4, embedding_dim=128, dropout=0.0)
    cpu_gen = torch.Generator().manual_seed(SEED)
    lm32 = VampNetLM(dataclasses.replace(base, compute_dtype="float32"), device="cpu")
    state = random_state(lm32, cpu_gen, fan_in=True)
    codes = torch.randint(0, base.vocab_size + 1, (2, base.n_codebooks, 200), generator=cpu_gen)
    cbs = torch.randn((base.n_codebooks, base.vocab_size, base.latent_dim), generator=cpu_gen)
    result = {}
    for label, kw, counter, want in (
        ("int8", dict(quantization="int8"), w8a8_matmul, 6 * base.n_layers),
        ("fused_ffn", dict(ffn_impl="fused"), fused_geglu_ffn, base.n_layers),
    ):
        sd = quantize_lm_state_dict(state) if label == "int8" else state
        cfg = dataclasses.replace(base, **kw)
        cpu_lm = VampNetLM(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
        cpu_lm.load_state_dict(sd)
        lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
        lm.load_state_dict(sd)
        n0 = counter.launches
        with torch.inference_mode():
            got = lm.forward_codes(codes.cuda(), cbs.cuda()).cpu()
            ref = cpu_lm.forward_codes(codes, cbs)
        if counter.launches - n0 != want:
            raise AssertionError(f"the small {label} LM made {counter.launches - n0} "
                                 f"launches, want {want}")
        err = float((got - ref).abs().max() / ref.abs().max())
        # bf16 activations through 2 layers against fp32; the int8 codes of
        # an activation within rounding of a boundary may differ by one
        if not err < 5e-2:
            raise AssertionError(f"small {label} LM logits on the card vs CPU fp32: rel err {err}")
        result[f"{label}_logits_rel_err"] = err
    return result


def staged_request(iface, sig, chunk_s, seed, **vamp_kw):
    """The Gradio app's sequence on the staged API: encode -> build_mask ->
    set_chunk_size -> vamp -> decode, at the app's mask settings; checks the
    vamped codes before decoding them. `vamp_kw` (top_k, cfg_guidance) goes
    to `vamp`."""
    codes = iface.encode(sig)
    mask = iface.build_mask(codes, periodic_prompt=7, upper_codebook_mask=3, seed=seed)
    iface.set_chunk_size(chunk_s)
    zv = iface.vamp(codes, mask, batch_size=2, _sampling_steps=12, seed=seed, **vamp_kw)
    n_cb = iface.c2f.config.n_codebooks
    if tuple(zv.shape) != (2, n_cb, codes.shape[-1]) or bool((zv == iface.coarse.mask_token).any()):
        raise AssertionError(f"staged vamp gave codes {tuple(zv.shape)} with MASK tokens left: "
                             f"{int((zv == iface.coarse.mask_token).sum())}")
    return iface.decode(zv)


def masked_stack_full_width(gen, t, valid):
    """A full-width coarse `TransformerStack` (20 layers, d=1280, bf16
    compute, fp32 parameters and T5 bias) at b=8 with a key-padding `x_mask`
    (batch rows open on `valid` keys): forward and backward, then an
    inference forward. Returns (results, launches of the masked kernels)."""
    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.modules.transformer import position_bias_from_params
    from vampnet_tpu_torch.ops import flash_attention as fa

    cfg = LMConfig.coarse(dropout=0.0)
    lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
    lm.load_state_dict(random_state(lm, gen))
    stack = lm.transformer
    b, d = TRAIN_BATCH, cfg.embedding_dim
    x = torch.randn((b, t, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((b, t, d), generator=gen, device="cuda")
    mask = key_padding_mask(b, t, valid)
    names = ("attention_fwd_lse_masked", "attention_bwd_fused_masked", "attention_fwd_masked",
             "attention_fwd_lse", "attention_bwd_fused", "attention_fwd_long")
    counters = {n: getattr(fa, n) for n in names}
    counters["attention_fwd"] = fa.flash_attention_with_bias
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bias = position_bias_from_params(lm, t)
    out = stack(x, bias, x_mask=mask)
    (out.float() * w).sum().backward()
    torch.cuda.synchronize()
    wall_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    made_train = {n: c.launches for n, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(attention_fwd_lse_masked=cfg.n_layers, attention_bwd_fused_masked=cfg.n_layers)
    if made_train != want:
        raise AssertionError(f"masked stack forward and backward: launches {made_train}, "
                             f"want {want}")
    grads = {n: p.grad for n, p in lm.named_parameters() if p.grad is not None}
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()) or \
            not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("masked stack: non-finite output or gradient")
    table = "transformer.layers_0.self_attn.relative_attention_bias"
    for name in (table, *(f"transformer.layers_{i}.self_attn.w_qs.weight"
                          for i in range(cfg.n_layers))):
        if name not in grads or not bool((grads[name] != 0).any()):
            raise AssertionError(f"masked stack: {name} received no gradient")
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out_inf = stack(x, bias.detach(), x_mask=mask)
    torch.cuda.synchronize()
    wall_inf = time.perf_counter() - t0
    made_inf = {n: c.launches for n, c in counters.items()}
    want_inf = dict(dict.fromkeys(counters, 0), attention_fwd_masked=cfg.n_layers)
    if made_inf != want_inf:
        raise AssertionError(f"masked stack inference: launches {made_inf}, want {want_inf}")
    # the inference kernel is the training forward without its lse rows
    if not torch.equal(out_inf, out.detach()):
        raise AssertionError("masked stack: the inference forward differs from the "
                             "training forward")
    result = dict(shape=f"b={b} t={t} d={d} layers={cfg.n_layers} valid keys {list(valid)}",
                  forward_backward_ms=wall_train * 1e3, inference_forward_ms=wall_inf * 1e3,
                  peak_gib=peak, launches_forward_backward=made_train,
                  launches_inference=made_inf)
    print("masked stack: " + json.dumps(result))
    launches = {n: made_train[n] for n in names[:2]}
    launches["attention_fwd_masked"] = made_inf["attention_fwd_masked"]
    return result, launches


def check_small_lms_against_cpu(gen):
    """Small models on the card (bf16 compute, through the kernels) against
    the CPU (fp32, the plain paths), from one set of weights: a masked
    `TransformerStack`'s output and gradients (K3's scores, K4 masked, K5),
    and an LM's logits at t = 1,100, past 1024 (K9)."""
    import dataclasses

    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.modules.transformer import position_bias_from_params
    from vampnet_tpu_torch.ops import flash_attention as fa

    cfg = LMConfig(n_heads=2, n_layers=2, n_codebooks=4, embedding_dim=128, dropout=0.0)
    cpu_gen = torch.Generator().manual_seed(SEED)
    lm32 = VampNetLM(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
    lm32.load_state_dict(random_state(lm32, cpu_gen, fan_in=True))
    lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
    lm.load_state_dict(lm32.state_dict())
    t = 200
    x = torch.randn((2, t, cfg.embedding_dim), generator=cpu_gen)
    w = torch.randn((2, t, cfg.embedding_dim), generator=cpu_gen)
    mask = key_padding_mask(2, t, (t, 130), device="cpu")

    def run(model, dev, dtype):
        params = [p for p in model.transformer.parameters()]
        bias = position_bias_from_params(model, t)
        out = model.transformer(x.to(dev, dtype), bias, x_mask=mask.to(dev))
        grads = torch.autograd.grad((out.float() * w.to(dev)).sum(), params)
        return out.detach().float().cpu(), [g.float().cpu() for g in grads]

    counters = (fa.attention_fwd_lse_masked, fa.attention_bwd_fused_masked)
    before = [c.launches for c in counters]
    out, grads = run(lm, "cuda", torch.bfloat16)
    if [c.launches - n for c, n in zip(counters, before)] != [cfg.n_layers] * 2:
        raise AssertionError("the small masked stack did not go through the masked kernels")
    out32, grads32 = run(lm32, "cpu", torch.float32)
    names = [n for n, _ in lm.transformer.named_parameters()]
    errs = {n: rel_err(g, g32) for n, g, g32 in zip(names, grads, grads32)}
    worst = max(errs, key=errs.get)
    out_err = rel_err(out, out32)
    # bf16 activations and products through 2 layers against fp32
    if not out_err <= 5e-2 or errs[worst] > 5e-2:
        raise AssertionError(f"small masked stack vs CPU fp32: output rel err {out_err}, "
                             f"worst gradient {worst} rel err {errs[worst]}")

    t_long = 1100
    codes = torch.randint(0, cfg.vocab_size + 1, (1, cfg.n_codebooks, t_long), generator=cpu_gen)
    cbs = torch.randn((cfg.n_codebooks, cfg.vocab_size, cfg.latent_dim), generator=cpu_gen)
    n0 = fa.attention_fwd_long.launches
    with torch.inference_mode():
        got = lm.forward_codes(codes.cuda(), cbs.cuda()).cpu()
        ref = lm32.forward_codes(codes, cbs)
    if fa.attention_fwd_long.launches - n0 != cfg.n_layers:
        raise AssertionError("the small LM at t=1100 did not go through the long forward")
    long_err = float((got - ref).abs().max() / ref.abs().max())
    if not long_err < 5e-2:
        raise AssertionError(f"small LM logits at t={t_long} on the card vs CPU fp32: "
                             f"rel err {long_err}")
    return dict(masked_stack_out_rel_err=out_err, masked_stack_grad_worst=worst,
                masked_stack_grad_worst_rel_err=errs[worst], long_logits_rel_err=long_err)


def check_sampler_top_k(gen):
    """K10 with `top_k` against its plain version, untimed but for two
    calls: at a CFG-doubled coarse request's shape (4, 3,448) with and
    without the typical filter, and at a c2f engine group's (16, 2,590) with
    it; top_k off (a cfg_guidance request's), 1, 8, 64 and 1,024, top-p off
    and 0.9, on logits rounded to multiples of 0.5 (ties at the k-th value).
    Then the kernel's time at top_k=64 beside its time without, at the
    first shape."""
    import torch

    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits, fused_sample_plain

    dev = "cuda"
    serving = dict(typical_filtering=True, typical_mass=0.15, typical_min_tokens=64)
    result = {}
    for b, flat, settings in ((4, 3448, (("typical", serving),
                                         ("no_typical", dict(typical_filtering=False)))),
                              (16, 2590, (("typical", serving),))):
        logits = torch.round(torch.randn((b, flat, 1024), generator=gen, device=dev) * 6.0) * 0.5
        keys = torch.randint(0, 2 ** 32, (b, 2), generator=gen, device=dev, dtype=torch.int64)
        temp = torch.full((b,), 1.0, device=dev)
        shape = {}
        for name, kw in settings:
            for top_k in (None, 1, 8, 64, 1024):
                for top_p in (None, 0.9):
                    extra = dict(kw, top_k=top_k)
                    if top_p is not None:
                        extra.update(use_top_p=True, top_p=top_p)
                    label = (f"{name}_top_k_{top_k or 'off'}"
                             + ("_top_p_0.9" if top_p else ""))
                    shape[label] = sampler_agreement(label, keys, logits, temp, **extra)
        result[f"b{b}_flat{flat}"] = shape
        if b == 4:
            io_bytes = logits.numel() * 4 + keys.numel() * 8 + b * flat * (8 + 4) + 3 * b * 4
            ops = logits.numel() * SAMPLER_OPS_PER_LOGIT
            bound = 1e3 * max(io_bytes / H100_BYTES_PER_S, ops / H100_FP32_FLOPS)
            for name, kw in settings:
                run = lambda k, kw=kw: fused_sample_from_logits(keys, 5, logits, temp, 1.0,
                                                                top_k=k, **kw)
                shape[f"{name}_ms_top_k_64"] = time_ms(lambda: run(64))
                shape[f"{name}_ms_no_top_k"] = time_ms(lambda: run(None))
                shape[f"{name}_plain_ms_top_k_64"] = time_ms(
                    lambda kw=kw: fused_sample_plain(keys, 5, logits, temp, 1.0, top_k=64, **kw),
                    reps=5)
            shape["bound_ms"] = bound
    mism = sum(v[f"{m}_token_mismatches"] for r in result.values() for v in r.values()
               if isinstance(v, dict) for m in ("greedy", "noisy"))
    ties = sum(v[f"{m}_tie_positions"] for r in result.values() for v in r.values()
               if isinstance(v, dict) for m in ("greedy", "noisy"))
    result.update(token_mismatches=mism, tie_positions=ties)
    print("kernel sampler[top_k]: " + json.dumps(result))
    return result


def staged_options(iface, sig, counters, want, n_samples):
    """Staged requests through `vamp` with top_k=64, cfg_guidance=3.0 and
    both: each must launch what a plain request does (the unconditional rows
    ride in the same forwards), and each is profiled beside a plain one."""
    results = {}
    busy_plain, _ = profile("staged plain request",
                            lambda: staged_request(iface, sig, 10, 90))
    for label, kw in (("top_k_64", dict(top_k=64)), ("cfg_guidance_3", dict(cfg_guidance=3.0)),
                      ("top_k_64_cfg_guidance_3", dict(top_k=64, cfg_guidance=3.0))):
        served, _ = serve(f"staged {label}",
                          lambda i, kw=kw: staged_request(iface, sig, 10, SEED + i, **kw), 1,
                          counters, want, n_samples)
        hits = {}
        busy, n_launch = profile(f"staged {label} request",
                                 lambda kw=kw: staged_request(iface, sig, 10, 90, **kw),
                                 totals=("attention_fwd_kernel", "sampler_kernel", "nvjet"),
                                 hits=hits)
        results[label] = dict(wall_ms=served["wall_ms"][0], peak_gib=served["peak_gib"],
                              busy_ms=busy, kernel_launches=n_launch,
                              launches_per_request=served["launches_per_request"],
                              kernel_ms={k: v[0] for k, v in hits.items()})
    results["plain_busy_ms"] = busy_plain
    print("staged options: " + json.dumps(results))
    return results


def sketch2sound_controller(hop, sr):
    from vampnet_tpu_torch.control import Sketch2SoundController

    # rmsq16: configs/lora/lora-s2s.yml's control; the chroma key runs the HPSS
    return Sketch2SoundController(["rmsq16", "hchroma-36c-top3"], hop_length=hop, sample_rate=sr)


def controls_full_width(iface, sig, gen):
    """A full-width coarse LM with the controller's `ctrl_dims` (bf16
    weights, random from `gen`): the controls extracted on the card from
    the preprocessed signal, then 12 MaskGIT steps with the controls' CFG,
    each forward over 2b rows (K1 240 and K10 12 launches)."""
    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.modules.transformer import position_bias_from_params
    from vampnet_tpu_torch.ops.flash_attention import flash_attention_with_bias
    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits
    from vampnet_tpu_torch.sampling.generate import generate

    import numpy as np

    cc = iface.codec_config
    ctl = sketch2sound_controller(cc.hop_length, cc.sample_rate)
    cfg = LMConfig.coarse(ctrl_dims=tuple(ctl.ctrl_dims.items()))
    lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
    lm.load_state_dict(random_state(lm, gen))
    for p in lm.parameters():
        p.data = p.data.to(torch.bfloat16)
    lm.requires_grad_(False).eval()
    pre = iface._preprocess(sig).samples[:, 0, :]  # a whole number of codec frames
    wav = torch.from_numpy(np.concatenate([pre, 0.5 * pre[:, ::-1]])).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctrls = ctl.extract(wav)
    torch.cuda.synchronize()
    extract_wall_ms = (time.perf_counter() - t0) * 1e3
    extract_ms = time_ms(lambda: ctl.extract(wav), reps=5)
    codes = iface.encode(sig)[:, : cfg.n_codebooks].expand(2, -1, -1).contiguous()
    t = codes.shape[-1]
    if any(v.shape[:2] != (2, t) for v in ctrls.values()):
        raise AssertionError(f"controls {[tuple(v.shape) for v in ctrls.values()]} "
                             f"for codes of {t} frames")
    if not all(bool(torch.isfinite(v).all()) for v in ctrls.values()):
        raise AssertionError("non-finite controls")
    cgen = torch.Generator(device="cuda").manual_seed(SEED)
    ctrl_masks = ctl.random_mask(ctrls, torch.full((2,), 0.3, device="cuda"), cgen)
    mask = iface.build_mask(codes, periodic_prompt=7, upper_codebook_mask=3, seed=SEED)
    bias = position_bias_from_params(lm, t)
    cbs = iface.codebooks[: cfg.n_codebooks]
    rows = []

    def forward(zm, c, cm):
        rows.append(zm.shape[0])
        return lm.forward_codes(zm, cbs, position_bias=bias, ctrls=c, ctrl_masks=cm)

    for c in (flash_attention_with_bias, fused_sample_from_logits):
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = generate(forward, codes, mask, cfg.mask_token, cgen, sampling_steps=12,
                       ctrls=ctrls, ctrl_masks=ctrl_masks, cfg_scale=3.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(attention_fwd=flash_attention_with_bias.launches,
                    sampler=fused_sample_from_logits.launches)
    if launches != dict(attention_fwd=12 * cfg.n_layers, sampler=12) or rows != [4] * 12:
        raise AssertionError(f"controls' CFG generation: launches {launches}, forward rows {rows}")
    if tuple(out.shape) != tuple(codes.shape) or bool((out == cfg.mask_token).any()):
        raise AssertionError("controls' CFG generation left MASK tokens or changed the shape")
    result = dict(ctrl_dims=cfg.ctrl_dims, extract_wall_ms=extract_wall_ms,
                  extract_ms=extract_ms, generate_wall_ms=wall * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=launches,
                  forward_rows=rows[0])
    print("controls: " + json.dumps(result))
    return result


def train_controller(codec, codebooks, gen, steps=2):
    """`steps` full-width coarse training steps at b=8 over 10 s with the
    controller: the controls extracted from the step's audio on the card,
    their masks drawn, the LM's ControlEncoder in the forward (K4 and K8 20
    each a step)."""
    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.ops.flash_attention import attention_bwd_fused, attention_fwd_lse
    from vampnet_tpu_torch.train import TrainState, make_optimizer, make_train_step

    ctl = sketch2sound_controller(codec.config.hop_length, codec.config.sample_rate)
    cfg = LMConfig.coarse(dropout=0.1, ctrl_dims=tuple(ctl.ctrl_dims.items()))
    lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
    lm.load_state_dict(random_state(lm, gen))
    opt = make_optimizer(cfg.embedding_dim)
    state = TrainState.create(lm, opt)
    step = make_train_step(lm, codec, opt, controller=ctl)
    audio = train_audio(codec.config.sample_rate, codec.config.hop_length, 10.0, TRAIN_BATCH)
    enc0 = {k: v.clone() for k, v in lm.ctrl_encoder.state_dict().items()}
    dgen = torch.Generator(device="cuda").manual_seed(SEED)
    counters = {"attention_fwd_lse": attention_fwd_lse, "attention_bwd_fused": attention_bwd_fused}
    walls, peaks, made_all = [], [], []
    for i in range(steps):
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, codebooks[: cfg.n_codebooks], audio, dgen)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        made = {n: c.launches for n, c in counters.items()}
        made_all.append(made)
        print(f"controller train step {i}: wall {walls[-1]:.1f} ms, peak {peaks[-1]:.2f} GiB, "
              f"loss {loss:.5f}, grad_norm {grad_norm:.5f}, launches {made}")
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise AssertionError(f"controller train step {i}: loss {loss}, grad_norm {grad_norm}")
        if any(m != cfg.n_layers for m in made.values()):
            raise AssertionError(f"controller train step {i}: launches {made}")
    moved = [k for k, v in lm.ctrl_encoder.state_dict().items() if not torch.equal(v, enc0[k])]
    if len(moved) != len(enc0):
        raise AssertionError(f"only {moved} of the control encoder moved")
    result = dict(step_ms=walls, peak_gib=max(peaks), launches_per_step=made_all[-1],
                  batch=tuple(audio.shape), ctrl_dims=cfg.ctrl_dims)
    print("controller train: " + json.dumps(result))
    return result


def beat_signal(sr, seconds, bpm=120.0):
    """The bench signal with a click track on it (a louder one every 4
    beats), so that onsets and beats are there to find."""
    import numpy as np

    from vampnet_tpu_torch.audio import AudioSignal

    x = bench_signal(sr, seconds).samples[0, 0].copy()
    period = int(sr * 60.0 / bpm)
    for k, start in enumerate(range(int(0.25 * sr), len(x) - period, period)):
        n = np.arange(int(0.03 * sr))
        x[start + n] += (0.8 if k % 4 == 0 else 0.4) * np.exp(-n / (0.004 * sr)) \
            * np.sin(2 * np.pi * 1500 * n / sr)
    return AudioSignal(x[None, None, :].astype(np.float32), sr)


def write_random_wavebeat(path, gen):
    """A wavebeat Lightning checkpoint at `wavebeat.py`'s default layout
    (8 blocks, kernel 15, 32 to 256 channels) with random weights and
    BatchNorm statistics from `gen`."""
    import torch

    from vampnet_tpu_torch.wavebeat import DsTCNConfig

    cfg = DsTCNConfig.build()
    sd = {}

    def rnd(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, device=gen.device)).cpu()

    for n, b in enumerate(cfg.blocks):
        base = f"blocks.{n}"
        sd[f"{base}.conv1.weight"] = rnd(b.out_ch, b.in_ch, b.kernel_size,
                                         scale=(b.in_ch * b.kernel_size) ** -0.5)
        sd[f"{base}.res_conv.weight"] = rnd(b.out_ch, b.in_ch, 1, scale=b.in_ch ** -0.5)
        sd[f"{base}.act1.weight"] = torch.full((b.out_ch,), 0.25)
        for norm in ("norm1", "res_norm"):
            sd[f"{base}.{norm}.running_mean"] = rnd(b.out_ch, scale=0.1)
            sd[f"{base}.{norm}.running_var"] = rnd(b.out_ch, scale=0.1, shift=1.0).abs()
            sd[f"{base}.{norm}.weight"] = rnd(b.out_ch, scale=0.1, shift=1.0)
            sd[f"{base}.{norm}.bias"] = rnd(b.out_ch, scale=0.1)
    sd["output.weight"] = rnd(cfg.noutputs, cfg.blocks[-1].out_ch, 1,
                              scale=cfg.blocks[-1].out_ch ** -0.5)
    sd["output.bias"] = torch.zeros(cfg.noutputs)
    hp = dict(ninputs=1, noutputs=2, nblocks=8, kernel_size=15, stride=2, dilation_growth=8,
              dilation_cycle=2, channel_width=32, channel_growth=32, sample_rate=22050)
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()},
                "hyper_parameters": hp}, path)
    return cfg


def masks_and_beats(iface, counters, want, gen):
    """The onset mask (`build_mask(onset_mask_width=2)`), `make_beat_mask`
    through the DP tracker and through a random-weight WaveBeat whose
    forward runs on the card, and the web app's "follow beat" preset served
    once with its beat mask applied (`vamp_core`)."""
    import tempfile

    import numpy as np
    import torch

    from vampnet_tpu_torch.beats import DPBeatTracker, WaveBeat
    from vampnet_tpu_torch.serve.app import PRESETS, vamp_core

    sr = iface.codec_config.sample_rate
    sig = beat_signal(sr, 10.0)
    codes = iface.encode(sig)
    t = codes.shape[-1]
    result = {}
    t0 = time.perf_counter()
    onset = iface.build_mask(codes, sig=sig, periodic_prompt=7, upper_codebook_mask=3,
                             onset_mask_width=2, seed=SEED)
    result["onset_mask_ms"] = (time.perf_counter() - t0) * 1e3
    plain = iface.build_mask(codes, periodic_prompt=7, upper_codebook_mask=3, seed=SEED)
    # the onset windows are kept on top of the periodic prompt
    kept, kept_plain = int((onset[0, 0] == 0).sum()), int((plain[0, 0] == 0).sum())
    if tuple(onset.shape) != tuple(codes.shape) or not kept_plain < kept < t:
        raise AssertionError(f"onset mask {tuple(onset.shape)} keeps {kept} of {t} steps, "
                             f"the periodic prompt alone {kept_plain}")
    result["onset_mask_kept_steps"] = kept

    def beat_mask(tracker, label):
        iface.beat_tracker = tracker
        t0 = time.perf_counter()
        m = iface.make_beat_mask(sig, after_beat_s=0.05)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_cb = iface.c2f.config.n_codebooks
        if tuple(m.shape) != (1, n_cb, t) or m.device.type != "cuda":
            raise AssertionError(f"{label} beat mask {tuple(m.shape)} on {m.device}")
        beats, down = tracker.extract_beats(sig)
        result[f"{label}_beat_mask_ms"] = ms
        result[f"{label}_beats"] = len(beats)
        result[f"{label}_downbeats"] = len(down)
        result[f"{label}_mask_kept_steps"] = int((m[0, 0] == 0).sum())
        return beats

    dp_beats = beat_mask(DPBeatTracker(), "dp")
    if len(dp_beats) < 10:
        raise AssertionError(f"the DP tracker found {len(dp_beats)} beats in 10 s of clicks")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/wavebeat.pth"
        write_random_wavebeat(path, gen)
        tracker = WaveBeat(path)
    if tracker.model is None or next(tracker.model.model.parameters()).device.type != "cuda":
        raise AssertionError("the WaveBeat checkpoint did not load onto the card")
    beat_mask(tracker, "wavebeat")
    x = sig.samples[0, 0]
    result["wavebeat_activations_ms"] = call_ms(lambda: tracker.model.activations(x, sr), reps=5)

    # the web app's "follow beat" preset, its beat mask from the DP tracker
    iface.beat_tracker = DPBeatTracker()
    calls = []
    orig = iface.make_beat_mask

    def spy(*a, **kw):
        calls.append(orig(*a, **kw))
        return calls[-1]

    iface.make_beat_mask = spy
    preset = "small variation (follow beat)"
    try:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = vamp_core(iface, (sr, x), seed=SEED + 1, sampling_steps=12, **PRESETS[preset])
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del iface.make_beat_mask
        iface.beat_tracker = None
    made = {n: c.launches for n, c in counters.items()}
    if len(calls) != 1 or not bool((calls[0] == 0).any()) or made != want:
        raise AssertionError(f"follow-beat preset: {len(calls)} beat masks, launches {made}")
    if not all(np.isfinite(v[1]).all() for v in res.variations) or len(res.variations) != 2:
        raise AssertionError("follow-beat preset: bad output")
    beat_steps = calls[0][0, 0] == 0
    if bool((torch.from_numpy(np.asarray(res.mask))[0, 0].to(beat_steps.device)[beat_steps]
             == iface.coarse.mask_token).any()):
        raise AssertionError("follow-beat preset: a step the beat mask keeps was regenerated")
    result["follow_beat"] = dict(preset=preset, wall_ms=wall, launches=made,
                                 beat_mask_kept_steps=int(beat_steps.sum()))
    print("masks: " + json.dumps(result))
    return result


def check_option_lms_against_cpu(gen):
    """Small LMs on the card against the CPU: a control LM's logits (card
    bf16 compute through the kernels, CPU fp32); then, for 4-step top_k,
    cfg_guidance and combined generations, sampling on, from shared per-row
    keys, K10 and the MaskGIT loop on the card against the plain sampler
    and the same loop on the CPU, both on the card's logits (the CPU's
    forward replays them). The conditioned rows' inputs must agree at every
    step; the unconditional rows' may part from the second step on, since
    they are all MASK and which of their tied positions are re-masked rests
    on the last bits of K10's and the plain sampler's probabilities (ROADMAP
    Queue C); what parts is counted."""
    import dataclasses

    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.ops import flash_attention as fa
    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits
    from vampnet_tpu_torch.sampling.generate import generate

    ctl = sketch2sound_controller(512, 44100)
    base = LMConfig(n_heads=2, n_layers=2, n_codebooks=4, embedding_dim=128, dropout=0.0)
    cpu_gen = torch.Generator().manual_seed(SEED)
    cfg = dataclasses.replace(base, ctrl_dims=tuple(ctl.ctrl_dims.items()))
    lm32 = VampNetLM(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
    lm32.load_state_dict(random_state(lm32, cpu_gen, fan_in=True))
    lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
    lm.load_state_dict(lm32.state_dict())
    t = 200
    codes = torch.randint(0, cfg.vocab_size + 1, (2, cfg.n_codebooks, t), generator=cpu_gen)
    cbs = torch.randn((cfg.n_codebooks, cfg.vocab_size, cfg.latent_dim), generator=cpu_gen)
    ctrls = {k: torch.rand((2, t, d), generator=cpu_gen) for k, d in cfg.ctrl_dims}
    cmasks = {k: torch.randint(0, 2, (2, t), generator=cpu_gen) for k, _ in cfg.ctrl_dims}
    n0 = fa.flash_attention_with_bias.launches
    with torch.inference_mode():
        got = lm.forward_codes(codes.cuda(), cbs.cuda(), ctrls={k: v.cuda() for k, v in ctrls.items()},
                               ctrl_masks={k: v.cuda() for k, v in cmasks.items()}).cpu()
        ref = lm32.forward_codes(codes, cbs, ctrls=ctrls, ctrl_masks=cmasks)
    if fa.flash_attention_with_bias.launches - n0 != cfg.n_layers:
        raise AssertionError("the small control LM did not go through K1")
    ctrl_err = float((got - ref).abs().max() / ref.abs().max())
    if not ctrl_err < 5e-2:  # bf16 through 2 layers against fp32, as the other checks
        raise AssertionError(f"small control LM logits on the card vs CPU fp32: {ctrl_err}")

    # the generations: the card's MaskGIT loop (K1, K10 with top_k, the
    # doubled cfg batch) against the CPU's (the plain sampler), both drawing
    # from the same per-row keys, the CPU fed the card's logits step by step.
    # Forwards in two precisions alone would part the tokens of a multi-step
    # run: a flip at one position moves every later step's context.
    lm_gpu = VampNetLM(base, device="meta").to_empty(device="cuda")
    lm_gpu.load_state_dict(random_state(lm_gpu, gen, fan_in=True))
    z = torch.randint(0, base.vocab_size, (2, base.n_codebooks, t), generator=cpu_gen)
    mask = torch.ones_like(z)
    mask[:, :, ::3] = 0
    keys = torch.randint(0, 2 ** 32, (2, 2), generator=cpu_gen, dtype=torch.int64)
    result = dict(control_logits_rel_err=ctrl_err)
    for label, kw in (("top_k_8", dict(top_k=8)), ("cfg_guidance_3", dict(cfg_guidance=3.0)),
                      ("top_k_8_cfg_guidance_3", dict(top_k=8, cfg_guidance=3.0))):
        seen = []

        def card_forward(zm):
            out = lm_gpu.forward_codes(zm, cbs.cuda())
            seen.append((zm.cpu(), out.cpu()))
            return out

        replay = iter(seen)
        diverged = []  # per step: (conditioned rows part, unconditional rows part)
        nb = z.shape[0]

        def cpu_forward(zm):
            zm_card, out = next(replay)
            diverged.append((not torch.equal(zm[:nb], zm_card[:nb]),
                             not torch.equal(zm[nb:], zm_card[nb:])))
            return out

        k10 = fused_sample_from_logits.launches
        with torch.inference_mode():
            card = generate(card_forward, z.cuda(), mask.cuda(), base.mask_token,
                            row_keys=keys.cuda(), sampling_steps=4, **kw).cpu()
            k10 = fused_sample_from_logits.launches - k10
            cpu = generate(cpu_forward, z, mask, base.mask_token, row_keys=keys,
                           sampling_steps=4, **kw)
        share = token_share(card.numpy(), cpu.numpy())
        cond_parted = sum(c for c, _ in diverged)
        if k10 != 4 or share > SOLO_BATCHED_BOUND or cond_parted:
            raise AssertionError(f"small LM {label}: tokens on the card vs CPU differ at {share} "
                                 f"(steps parted, conditioned/unconditional rows: {diverged}), "
                                 f"K10 launches {k10}")
        result[f"{label}_token_share_differing"] = share
        result[f"{label}_uncond_steps_parted"] = sum(u for _, u in diverged)
    return result


def fused_interface(iface):
    """An Interface whose LMs take `ffn_impl="fused"` and share `iface`'s
    weight tensors (no copy), so that its peak memory compares with the
    served one's and dropping it frees nothing that `iface` holds."""
    import dataclasses

    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.modules import VampNetLM

    lms = []
    for served in (iface.coarse, iface.c2f):
        lm = VampNetLM(dataclasses.replace(served.config, ffn_impl="fused"), device="meta")
        lm.load_state_dict(served.state_dict(), assign=True)
        lms.append(lm.requires_grad_(False).eval())
    return Interface(iface.codec, *lms)

def write_reference_lm(path, state, cfg):
    """Write an LM as upstream VampNet saves one, from the port's state dict
    (CPU tensors): the audiotools wrapper `{"state_dict", "metadata":
    {"kwargs"}}`, loralib's adapter names (`lora_A` (r, in), `lora_B`
    (out, r)), a k=1 conv `embedding.out_proj`, a weight-normed classifier
    (v the weight, g its row norms) with vocab-major channels, and a control
    encoder's Linears as `ctrl_encoder.ctrl_encoders.{name}`."""
    import torch

    v, n_pred = cfg.vocab_size, cfg.n_predict_codebooks
    k = torch.arange(v * n_pred)
    perm = (k % v) * n_pred + k // v  # the converter's codebook-major order
    w = torch.empty_like(state["classifier.weight"])
    w[perm] = state["classifier.weight"]
    b = torch.empty_like(state["classifier.bias"])
    b[perm] = state["classifier.bias"]
    sd = {"embedding.special.MASK": state["embedding.special_MASK"],
          "embedding.out_proj.weight": state["embedding.out_proj.weight"][:, :, None],
          "embedding.out_proj.bias": state["embedding.out_proj.bias"],
          "classifier.layers.0.weight_v": w[:, :, None],
          "classifier.layers.0.weight_g": torch.linalg.vector_norm(w, dim=1)[:, None, None],
          "classifier.layers.0.bias": b}
    for key, x in state.items():
        if key.startswith("ctrl_encoder.ctrl_"):
            sd["ctrl_encoder.ctrl_encoders." + key[len("ctrl_encoder.ctrl_"):]] = x
        if not key.startswith("transformer."):
            continue
        name = key.replace(".layers_", ".layers.")
        if name.endswith((".lora_a", ".lora_b")):
            name, x = name[:-1] + name[-1].upper(), x.T
        elif name.endswith("relative_attention_bias"):
            name += ".weight"
        sd[name] = x.contiguous()
    kwargs = dict(n_heads=cfg.n_heads, n_layers=cfg.n_layers, n_codebooks=cfg.n_codebooks,
                  n_conditioning_codebooks=cfg.n_conditioning_codebooks,
                  latent_dim=cfg.latent_dim, embedding_dim=cfg.embedding_dim,
                  vocab_size=cfg.vocab_size, dropout=cfg.dropout)
    torch.save({"state_dict": sd, "metadata": {"kwargs": kwargs}}, path)


class HookCounter:
    """Forward hooks on every LoRADense with adapters: `launches` counts the
    adapter sites that ran (read by `serve` like a kernel's counter)."""

    def __init__(self, *lms):
        from vampnet_tpu_torch.modules.lora import LoRADense

        self.launches = 0
        self.hooks = [m.register_forward_hook(self.count) for lm in lms
                      for m in lm.modules() if isinstance(m, LoRADense) and m.r > 0]

    def count(self, *_):
        self.launches += 1

    def remove(self):
        for h in self.hooks:
            h.remove()


def record_codes(iface):
    """Keep the codes each request hands the codec's decode (its tokens)."""
    seen = []
    decode = iface.codec.decode_codes

    def recording(codes):
        seen.append(codes.cpu())
        return decode(codes)

    iface.codec.decode_codes = recording
    return seen


def lora_state(module, gen):
    """`random_state(fan_in=True)` weights (activations O(1) at any width),
    and adapters about 3% of the product they sit beside: `lora_a`
    normal / sqrt(fan-in), `lora_b` 0.1 normal (with the scale 1/8)."""
    state = random_state(module, gen, fan_in=True)
    for k, x in state.items():
        if k.endswith(".lora_a"):
            state[k] = x / x.shape[0] ** 0.5
        elif k.endswith(".lora_b"):
            state[k] = 0.1 * x
    return state


def file_gib(path) -> float:
    import os

    return os.path.getsize(path) / 2 ** 30


def check_lora_lms_against_cpu():
    """A small `lora_r=8` LM on the card (bf16 compute, through the attention
    kernel; int8 through the w8a8 kernel as well) against the CPU's plain
    fp32 path, from one set of weights and one input."""
    import dataclasses

    import torch

    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.modules.quantize import quantize_lm_state_dict
    from vampnet_tpu_torch.ops.flash_attention import flash_attention_with_bias
    from vampnet_tpu_torch.ops.int8_matmul import w8a8_matmul

    base = LMConfig(n_heads=2, n_layers=2, n_codebooks=4, embedding_dim=128, dropout=0.0,
                    lora_r=8)
    cpu_gen = torch.Generator().manual_seed(SEED)
    lm32 = VampNetLM(dataclasses.replace(base, compute_dtype="float32"), device="cpu")
    state = lora_state(lm32, cpu_gen)
    codes = torch.randint(0, base.vocab_size + 1, (2, base.n_codebooks, 200), generator=cpu_gen)
    cbs = torch.randn((base.n_codebooks, base.vocab_size, base.latent_dim), generator=cpu_gen)
    result = {}
    for label, kw in (("lora_bf16", {}), ("lora_int8", dict(quantization="int8"))):
        sd = quantize_lm_state_dict(state) if kw else state
        cfg = dataclasses.replace(base, **kw)
        cpu_lm = VampNetLM(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
        cpu_lm.load_state_dict(sd)
        lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
        lm.load_state_dict(sd)
        n0 = (flash_attention_with_bias.launches, w8a8_matmul.launches)
        with torch.inference_mode():
            got = lm.forward_codes(codes.cuda(), cbs.cuda()).cpu()
            ref = cpu_lm.forward_codes(codes, cbs)
        made = (flash_attention_with_bias.launches - n0[0], w8a8_matmul.launches - n0[1])
        if made != (base.n_layers, 6 * base.n_layers if kw else 0):
            raise AssertionError(f"the small {label} LM made (attention, w8a8) launches {made}")
        err = float((got - ref).abs().max() / ref.abs().max())
        # bf16 activations through 2 layers against fp32, as the other small LMs
        if not err < 5e-2:
            raise AssertionError(f"small {label} LM logits on the card vs CPU fp32: rel err {err}")
        result[f"{label}_logits_rel_err"] = err
    return result


def serve_from_files(codec, sig, kw, counters, want, n_samples, busy_bf16, launches_bf16):
    """Phase 13: the published architecture (LoRA rank 8 at every adapter
    site, full width) served from checkpoint files that this run writes in
    a temporary directory: reference-layout `.pth` LMs and a `.vtpu` codec,
    then the converted LMs as `.vtpu`, then a models directory with a LoRA
    fine-tune. Returns the phase's summary and the kernels' launches over
    its first (bf16, `.pth`) run."""
    import importlib
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vampnet_tpu_torch.checkpoints import load_lm, save_codec, save_lm
    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.modules.lora import LORA_LEAVES, LORA_R
    from vampnet_tpu_torch.util import flatten_tree, unflatten_tree

    t_phase = time.perf_counter()
    # nothing here may reach the network: a missing file must fail as it
    # fails offline
    sys.modules["huggingface_hub"] = None
    cfgs = {"coarse": LMConfig.coarse(lora_r=LORA_R), "c2f": LMConfig.c2f(lora_r=LORA_R)}
    n_params = sum(v.numel() for cfg in cfgs.values()
                   for v in VampNetLM(cfg, device="meta").state_dict().values())
    # an fp32 .pth and .vtpu of each LM, a bf16 fine-tune, the codec; a margin
    need = 1.25 * (n_params * (4 + 4 + 2) + sum(v.numel() * 4 for v in codec.state_dict().values()))
    gen = torch.Generator().manual_seed(SEED + 13)
    sizes, seconds = {}, {}
    n_sites = 5 * (cfgs["coarse"].n_layers + cfgs["c2f"].n_layers)
    n_layer_calls = want["attention_fwd"]

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_checkpoints_") as tmp:
        root = Path(tmp)
        models = root / "models"
        free = shutil.disk_usage(root).free
        if free < need:
            raise AssertionError(f"phase 13 needs {need / 2 ** 30:.1f} GiB free in {root}, "
                                 f"which has {free / 2 ** 30:.1f} GiB")
        # ---- 13.1-2: random LoRA LMs, written in upstream's layout ----
        states = {}
        for name, cfg in cfgs.items():
            st = states[name] = lora_state(VampNetLM(cfg, device="meta"), gen)
            timed(f"write {name}.pth", lambda: write_reference_lm(root / f"{name}.pth", st, cfg))
            sizes[f"{name}.pth"] = file_gib(root / f"{name}.pth")
        codec_tree = unflatten_tree({tuple(k.split(".")): v.cpu()
                                     for k, v in codec.state_dict().items()})
        timed("write codec.vtpu", lambda: save_codec(models / "codec.vtpu", codec.config,
                                                      codec_tree))
        sizes["codec.vtpu"] = file_gib(models / "codec.vtpu")

        # ---- 13.3: serve from the .pth files ----
        pth = timed("load .pth interface", lambda: Interface.from_checkpoints(
            coarse_ckpt=root / "coarse.pth", coarse2fine_ckpt=root / "c2f.pth",
            codec_ckpt=models / "codec.vtpu", device="cuda"))
        for name in cfgs:
            loaded = getattr(pth, name).state_dict()
            for k, x in states[name].items():
                want_x = x.to(torch.bfloat16)
                got_x = loaded[k].cpu()
                if k == "classifier.weight":  # g v / |v|: within a rounding of bf16
                    ok = bool(((got_x.float() - want_x.float()).abs()
                               <= 2 ** -7 * want_x.float().abs()).all())
                else:
                    ok = torch.equal(got_x, want_x)
                if not ok:
                    raise AssertionError(f"{name} {k} loaded from .pth differs from its source")
        del states
        hooks = HookCounter(pth.coarse, pth.c2f)
        lora_counters = dict(counters, lora_sites=hooks)
        want_lora = dict(want, lora_sites=5 * n_layer_calls)  # 5 adapter sites a layer
        pth_codes = record_codes(pth)
        served_pth, launches = serve("lora .pth", lambda i: pth.vamp_e2e(
            sig, seed=SEED + i, **kw), REQUESTS, lora_counters, want_lora, n_samples)
        hooks.remove()
        if len(hooks.hooks) != n_sites:
            raise AssertionError(f"{len(hooks.hooks)} LoRA sites, want {n_sites}")
        saved = {}
        for lm in (pth.coarse, pth.c2f):
            for n_, p_ in lm.named_parameters():
                if n_.endswith(".lora_b"):
                    saved[p_] = p_.detach().clone()
                    p_.data.zero_()
        pth.vamp_e2e(sig, seed=SEED, **kw)
        for p_, x in saved.items():
            p_.data.copy_(x)
        moved = float((pth_codes[-1] != pth_codes[0]).float().mean())
        if moved == 0.0:
            raise AssertionError("zeroing lora_b left every token as it was")
        del pth_codes[REQUESTS:], saved

        # ---- 13.4: the converted LMs as .vtpu, served again ----
        trees = {}
        for name in cfgs:
            cfg, trees[name] = timed(f"convert {name}.pth", lambda: load_lm(root / f"{name}.pth"))
            timed(f"write {name}.vtpu", lambda: save_lm(models / f"{name}.vtpu", cfg, trees[name]))
            sizes[f"{name}.vtpu"] = file_gib(models / f"{name}.vtpu")
            os.remove(root / f"{name}.pth")
        del pth
        torch.cuda.empty_cache()
        vt = timed("load .vtpu interface", lambda: Interface.from_checkpoints(
            coarse_ckpt=models / "coarse.vtpu", coarse2fine_ckpt=models / "c2f.vtpu",
            codec_ckpt=models / "codec.vtpu", device="cuda"))
        vt_codes = record_codes(vt)
        served_vtpu, _ = serve("lora .vtpu", lambda i: vt.vamp_e2e(sig, seed=SEED + i, **kw),
                               REQUESTS, counters, want, n_samples)
        if not all(torch.equal(a, b) for a, b in zip(vt_codes, pth_codes)):
            raise AssertionError("the .vtpu-loaded Interface's tokens differ from the .pth one's")
        busy_lora, n_lora = profile("lora request", lambda: vt.vamp_e2e(sig, seed=99, **kw),
                                    totals=("nvjet", "sampler_kernel"))
        print(f"profile: lora request busy {busy_lora:.1f} ms in {n_lora} kernel launches, "
              f"bf16 request busy {busy_bf16:.1f} ms in {launches_bf16} (phase 7; one "
              f"request each, the same signal and settings)")

        # ---- 13.5: a models directory with a fine-tune ----
        ft_name = "smoke_finetune"
        for name, cfg in cfgs.items():
            ft = {p: (torch.randn(x.shape, generator=gen) * (
                      x.shape[0] ** -0.5 if p[-1] == "lora_a" else 0.1)
                      if p[-1] in LORA_LEAVES else x).to(torch.bfloat16)
                  for p, x in flatten_tree(trees[name]).items()}
            path = models / "loras" / ft_name / f"{name}.vtpu"
            timed(f"write fine-tune {name}.vtpu (bf16)",
                  lambda: save_lm(path, cfg, unflatten_tree(ft)))
            sizes[f"loras/{ft_name}/{name}.vtpu"] = file_gib(path)
        del trees, ft
        os.environ["VAMPNET_MODELS_DIR"] = str(models)
        from vampnet_tpu_torch import registry

        # the registry reads the variable when it is imported, and phase 8b's
        # web app (/health) imported it already
        importlib.reload(registry)
        if registry.MODELS_DIR != models:
            raise AssertionError(f"registry read its models directory before it was set: "
                                 f"{registry.MODELS_DIR}")
        available = Interface.available_models()
        if available != [ft_name, "default"]:
            raise AssertionError(f"available_models() = {available}")
        dflt = timed("Interface.default()", Interface.default)
        d_codes = record_codes(dflt)
        served_default, _ = serve("default", lambda i: dflt.vamp_e2e(sig, seed=SEED, **kw), 1,
                                  counters, want, n_samples)
        if not torch.equal(d_codes[0], pth_codes[0]):
            raise AssertionError("Interface.default() gives other tokens than its .pth source")
        timed("load_finetuned", lambda: dflt.load_finetuned(ft_name))
        served_ft, _ = serve("fine-tune", lambda i: dflt.vamp_e2e(sig, seed=SEED, **kw), 1,
                             counters, want, n_samples)
        ft_moved = float((d_codes[1] != d_codes[0]).float().mean())
        if ft_moved == 0.0:
            raise AssertionError("load_finetuned left every token as it was")
        before = (dflt.coarse, dflt.c2f)
        timed("reload with the same paths", lambda: dflt.reload(dflt.coarse_path, dflt.c2f_path))
        if (dflt.coarse, dflt.c2f) != before:
            raise AssertionError("reload with the loaded paths swapped the models")
        del dflt, d_codes
        torch.cuda.empty_cache()

        # ---- 13.6: int8 serving of the LoRA Interface ----
        timed("quantize", vt.quantize)
        hooks = HookCounter(vt.coarse, vt.c2f)
        want_int8 = dict(want_lora, w8a8_matmul=6 * n_layer_calls)
        served_int8, int8_launches = serve(
            "lora int8", lambda i: vt.vamp_e2e(sig, seed=SEED + i, **kw), OPTION_REQUESTS,
            dict(counters, lora_sites=hooks), want_int8, n_samples)
        hooks.remove()
        busy_int8, n_int8 = profile("lora int8 request",
                                    lambda: vt.vamp_e2e(sig, seed=98, **kw),
                                    totals=("w8a8_wgmma_kernel", "nvjet"))
        del vt
        torch.cuda.empty_cache()

    # ---- 13.7: a small LoRA LM on the card against the CPU ----
    cpu = check_lora_lms_against_cpu()
    print("cpu check: " + json.dumps(cpu))
    summary = dict(sizes_gib=sizes, seconds=seconds, served_pth=served_pth,
                   served_vtpu=served_vtpu, served_default=served_default,
                   served_finetune=served_ft, served_int8=served_int8,
                   zeroed_lora_b_tokens_moved=moved, finetune_tokens_moved=ft_moved,
                   lora_busy_ms=busy_lora, lora_kernel_launches=n_lora,
                   lora_int8_busy_ms=busy_int8, lora_int8_kernel_launches=n_int8,
                   cpu=cpu, phase_s=time.perf_counter() - t_phase)
    print("checkpoint phase: " + json.dumps(summary))
    return summary, launches, int8_launches

def engine_run(engine, reqs, timeout=600):
    """Submit `reqs` at once; (outputs, wall s, each request's latency s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = [0.0] * len(reqs)
    futs = []
    for i, r in enumerate(reqs):
        fut = engine.submit(r)
        fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append(fut)
    outs = [f.result(timeout=timeout) for f in futs]
    wall = time.perf_counter() - t0
    return outs, wall, [d - t0 for d in done]


def nearest_rank(xs, q) -> float:
    """The q-th percentile by nearest rank: the latency of one request."""
    xs = sorted(xs)
    return float(xs[max(math.ceil(q / 100 * len(xs)), 1) - 1])


def token_share(a, b) -> float:
    """The share of tokens that differ between two outputs of one shape."""
    if a.shape != b.shape:
        raise AssertionError(f"token shapes differ: {a.shape} vs {b.shape}")
    return float((a != b).mean())


def serve_engine_and_webapp(iface, sig, counters, card):
    """Phase 8b: the serving stack on the full-width bf16 Interface. The
    continuous-batching engine (`VampEngine`, max_batch 8, max_wait 5 ms,
    pipeline_depth 2) serves 16 requests on one encoded 10 s signal, each
    with its own mask (`build_mask(periodic_prompt=7, upper_codebook_mask=3,
    seed=k)`), seed k = 1-16, temperature 0.8 / 1.0 / 1.2 in turn, top-p off
    for the first 8 and 0.9 for the rest (two static groups), 12 steps;
    first one at a time (twice: the same tokens bit for bit), then all 16 at
    once. K1 and K10 are first held against their plain versions at an
    8-request group's shapes (`check_engine_shapes`). Each request's batched
    tokens are held to its solo ones, and its solo ones to a direct
    `coarse_vamp(seed=[s])` + `coarse_to_fine(seed=[s + 0x9E3779B9])`,
    within SOLO_BATCHED_BOUND. One 8-request group is profiled (K1 and K10
    launches, busy time, peak memory), and so are that group's per-row
    Philox draws alone; the card's idle share is measured over the 16 at
    pipeline_depth 1, 2, 2, 1. Latencies are nearest-rank percentiles. Then the
    stdlib web app on the same engine answers /health, /presets and
    HTTP_CLIENTS concurrent clients, each POSTing the 10 s WAV for two
    variations, and one ?format=wav request. Returns the phase's summary
    and K1's and K10's launches per engine group."""
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from urllib.parse import quote

    import numpy as np
    import torch

    from vampnet_tpu_torch.interface import _expand_row_keys
    from vampnet_tpu_torch.sampling.sample import remask_noise
    from vampnet_tpu_torch.serve import VampEngine, VampRequest, make_server
    from vampnet_tpu_torch.serve.webapp import audio_to_wav_bytes, wav_bytes_to_audio

    t_phase = time.perf_counter()
    iface.set_chunk_size(10)
    codes = iface.encode(sig)
    codes_np = codes.cpu().numpy()
    t_tokens = codes_np.shape[-1]
    audio_s = t_tokens * iface.codec_config.hop_length / iface.codec_config.sample_rate
    reqs = []
    for k in range(1, ENGINE_REQUESTS + 1):
        mask = iface.build_mask(codes, periodic_prompt=7, upper_codebook_mask=3, seed=k)
        reqs.append(VampRequest(codes=codes_np, mask=mask.cpu().numpy(), seed=k,
                                temperature=(0.8, 1.0, 1.2)[(k - 1) % 3],
                                top_p=None if k <= ENGINE_REQUESTS // 2 else 0.9,
                                sampling_steps=12))
    attn, samp = counters["attention_fwd"], counters["sampler"]
    per_group = 12 * iface.coarse.config.n_layers + 2 * iface.c2f.config.n_layers  # 272
    # K1 and K10 at the shapes an 8-request group gives them, before the
    # engine runs (these launches fall outside every counted run)
    shape_checks = check_engine_shapes(iface, t_tokens, 8)
    print("engine: kernels at a group's shapes: " + json.dumps(shape_checks))
    eng = VampEngine(iface, max_batch=8, max_wait_ms=5, pipeline_depth=2)
    result = dict(card=card, requests=ENGINE_REQUESTS, audio_s_per_request=audio_s,
                  kernel_checks=shape_checks)
    try:
        t0 = time.perf_counter()
        eng.warmup((1, 2, 4, 8), sampling_steps=12)
        result["warmup_s"] = time.perf_counter() - t0

        # ---- concurrency 1: one request at a time, twice ----
        solo, solo_lat = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            t_req = time.perf_counter()
            solo.append(eng.vamp(r, timeout=600))
            solo_lat.append(time.perf_counter() - t_req)
        wall_seq = time.perf_counter() - t0
        again = [eng.vamp(r, timeout=600) for r in reqs]
        for k, (a, b) in enumerate(zip(solo, again), 1):
            if not np.array_equal(a, b):
                raise AssertionError(f"request {k} served alone twice differs in "
                                     f"{token_share(a, b)} of its tokens")
            if a.shape != codes_np.shape or (a == iface.coarse.mask_token).any():
                raise AssertionError(f"request {k}: tokens {a.shape} with MASK left")

        # ---- concurrency 16: all at once; the kernels' counts over the run ----
        before = dict(eng.stats)
        attn.launches = samp.launches = 0
        batched, wall16, lat16 = engine_run(eng, reqs)
        launches = {"attention_fwd": attn.launches, "sampler": samp.launches}
        groups = eng.stats["batches"] - before["batches"]
        shared = eng.stats["batched_requests"] - before["batched_requests"]
        print(f"engine: 16 at once in {groups} groups, {shared} requests shared a group, "
              f"launches {launches}")
        if shared < 2 or groups >= ENGINE_REQUESTS:
            raise AssertionError(f"the engine did not batch: {groups} groups, {shared} shared")
        if launches != {"attention_fwd": per_group * groups, "sampler": 14 * groups}:
            raise AssertionError(f"launches {launches} for {groups} groups, want "
                                 f"{per_group} and 14 a group")
        shares = [token_share(b, a) for a, b in zip(solo, batched)]
        print("engine: batched vs solo token share per request: " + json.dumps(shares))
        if max(shares) > SOLO_BATCHED_BOUND:
            raise AssertionError(f"batched tokens differ from solo in up to {max(shares)}, "
                                 f"bound {SOLO_BATCHED_BOUND}")

        # ---- each request as direct per-row-seed staged calls ----
        direct_shares = []
        for r, a in zip(reqs, solo):
            def knob(v):
                return torch.tensor([v], dtype=torch.float32, device=iface.device)

            kn = dict(temperature=knob(r.temperature), mask_temperature=knob(r.mask_temperature),
                      top_p=None if r.top_p is None else knob(r.top_p),
                      sample_cutoff=knob(r.sample_cutoff))
            z = iface.coarse_vamp(r.codes, r.mask, seed=[r.seed], _sampling_steps=12, **kn)
            z = iface.coarse_to_fine(z, mask=r.mask, seed=[(r.seed + 0x9E3779B9) % 2 ** 32],
                                     **kn)
            direct_shares.append(token_share(z.cpu().numpy(), a))
        print("engine: solo vs direct staged calls token share per request: "
              + json.dumps(direct_shares))
        if max(direct_shares) > SOLO_BATCHED_BOUND:
            raise AssertionError(f"engine tokens differ from the direct calls in up to "
                                 f"{max(direct_shares)}")

        # ---- one 8-request group: launches, busy time, peak memory ----
        group8 = reqs[:8]
        hits = {}
        torch.cuda.reset_peak_memory_stats()
        busy8, n8 = profile("engine group of 8", lambda: engine_run(eng, group8),
                            totals=("attention_fwd_kernel", "sampler_kernel", "nvjet"),
                            hits=hits)
        peak8 = torch.cuda.max_memory_allocated() / 2 ** 30
        group_launches = {"attention_fwd": hits["attention_fwd_kernel"][1],
                          "sampler": hits["sampler_kernel"][1]}
        if group_launches != {"attention_fwd": per_group, "sampler": 14}:
            raise AssertionError(f"one 8-request group launched {group_launches}, want "
                                 f"{per_group} and 14")

        # ---- the per-row Philox draws of that group, alone: launches, card
        # time and the host's time to enqueue them ----
        k8 = torch.randint(0, 2 ** 32, (8, 2), device="cuda", dtype=torch.int64)
        flat_coarse = t_tokens * iface.coarse.config.n_predict_codebooks
        c2f_chunk = iface.s2t(iface.c2f.chunk_size_s)
        n_c2f_chunks = math.ceil(t_tokens / c2f_chunk)
        flat_c2f = c2f_chunk * iface.c2f.config.n_predict_codebooks

        def philox_draws():
            for i in range(12):
                remask_noise(k8, i, flat_coarse)
            k_c2f = _expand_row_keys(k8, n_c2f_chunks)
            for i in range(2):
                remask_noise(k_c2f, i, flat_c2f)

        philox_busy, philox_n = profile("per-row Philox draws of an 8-group", philox_draws)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            philox_draws()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        philox = dict(kernel_launches=philox_n, busy_ms=philox_busy,
                      host_enqueue_ms=sorted(host)[len(host) // 2] * 1e3,
                      share_of_group_launches=philox_n / n8)
        print("engine: per-row Philox draws of an 8-group: " + json.dumps(philox))

        # ---- the card's idle share over the 16 at pipeline_depth 1 and 2,
        # in the order 1, 2, 2, 1; busy time from a profiled run, wall time
        # from an unprofiled run just before it (the profiler slows the host) ----
        idle = {"depth1": [], "depth2": []}
        eng1 = VampEngine(iface, max_batch=8, max_wait_ms=5, pipeline_depth=1)
        try:
            for depth in (1, 2, 2, 1):
                e = eng if depth == 2 else eng1
                _, wall, _ = engine_run(e, reqs)
                busy, _ = profile(f"engine 16 at pipeline_depth {depth}",
                                  lambda: engine_run(e, reqs))
                idle[f"depth{depth}"].append(dict(wall_s=wall, busy_ms=busy,
                                                  idle_share=1 - busy / (wall * 1e3)))
        finally:
            eng1.close()
        result.update(
            sequential=dict(wall_s=wall_seq, requests_per_s=ENGINE_REQUESTS / wall_seq,
                            audio_s_per_s=ENGINE_REQUESTS * audio_s / wall_seq,
                            p50_latency_s=nearest_rank(solo_lat, 50),
                            p90_latency_s=nearest_rank(solo_lat, 90)),
            concurrent=dict(wall_s=wall16, requests_per_s=ENGINE_REQUESTS / wall16,
                            audio_s_per_s=ENGINE_REQUESTS * audio_s / wall16,
                            p50_latency_s=nearest_rank(lat16, 50),
                            p90_latency_s=nearest_rank(lat16, 90),
                            latencies_s=sorted(lat16), groups=groups, launches=launches),
            philox=philox,
            group8=dict(busy_ms=busy8, kernel_launches=n8, peak_gib=peak8,
                        launches=group_launches,
                        k1_ms=hits["attention_fwd_kernel"][0],
                        k10_ms=hits["sampler_kernel"][0], gemm_ms=hits["nvjet"][0]),
            idle=idle, solo_batched_share_max=max(shares),
            solo_batched_share_mean=float(np.mean(shares)),
            solo_direct_share_max=max(direct_shares))

        # ---- the stdlib web app on the same engine ----
        # the registry lists fine-tunes through huggingface_hub where it can
        # import it: it must not try, here
        sys.modules["huggingface_hub"] = None
        server = make_server(iface, host="127.0.0.1", port=0, engine=eng)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            def request(method, path, body=None, ctype=None):
                conn = http.client.HTTPConnection(*server.server_address, timeout=600)
                try:
                    conn.request(method, path, body=body,
                                 headers={"Content-Type": ctype} if ctype else {})
                    resp = conn.getresponse()
                    return resp.status, resp.getheader("Content-Type"), resp.read()
                finally:
                    conn.close()

            status, _, data = request("GET", "/health")
            if status != 200 or json.loads(data)["status"] != "ok":
                raise AssertionError(f"/health: {status} {data[:200]}")
            status, _, data = request("GET", "/presets")
            if status != 200 or "medium variation" not in json.loads(data):
                raise AssertionError(f"/presets: {status} {data[:200]}")
            sr = sig.sample_rate
            wav = audio_to_wav_bytes(sr, sig.samples[0, 0])
            n_out = t_tokens * iface.codec_config.hop_length

            def check_wav(raw, label):
                out_sr, x = wav_bytes_to_audio(raw)
                if out_sr != sr or x.shape != (n_out,) or not np.isfinite(x).all() or \
                        float(np.abs(x).max()) < 1e-3:
                    raise AssertionError(f"{label}: {out_sr} Hz, {x.shape}, "
                                         f"peak {float(np.abs(x).max())}")

            def client(k):
                t0 = time.perf_counter()
                status, _, data = request(
                    "POST", f"/api/vamp?preset={quote('medium variation')}&sampling_steps=12"
                    f"&seed={k}&batch_size=2", wav, "audio/wav")
                wall = time.perf_counter() - t0
                if status != 200:
                    raise AssertionError(f"client {k}: {status} {data[:500]}")
                out = json.loads(data)
                if out["seed"] != k or len(out["variations"]) != 2:
                    raise AssertionError(f"client {k}: seed {out['seed']}, "
                                         f"{len(out['variations'])} variations")
                for v in out["variations"]:
                    check_wav(base64.b64decode(v), f"client {k}")
                return wall

            before = dict(eng.stats)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(HTTP_CLIENTS) as ex:
                walls = list(ex.map(client, range(1, HTTP_CLIENTS + 1), timeout=900))
            http_wall = time.perf_counter() - t0
            for k, w in enumerate(walls, 1):
                print(f"web app: client {k} wall {w * 1e3:.1f} ms")
            t0 = time.perf_counter()
            status, ctype, data = request(
                "POST", f"/api/vamp?sampling_steps=12&seed=99&batch_size=1&format=wav", wav,
                "audio/wav")
            wav_wall = time.perf_counter() - t0
            if status != 200 or ctype != "audio/wav":
                raise AssertionError(f"?format=wav: {status} {ctype}")
            check_wav(data, "?format=wav")
            print(f"web app: ?format=wav request wall {wav_wall * 1e3:.1f} ms")
            result["webapp"] = dict(
                client_wall_s=walls, clients_wall_s=http_wall, format_wav_wall_s=wav_wall,
                engine_groups=eng.stats["batches"] - before["batches"],
                engine_requests=eng.stats["requests"] - before["requests"])
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=60)
    finally:
        eng.close()
    result["phase_s"] = time.perf_counter() - t_phase
    print("engine phase: " + json.dumps(result))
    return result, group_launches


def codec_weights(module, gen):
    """Codec weights whose codes spread over the codebooks at any width:
    weight-norm directions normal, gains 0.3-0.7, snake alphas 0.5-1.5,
    biases 0.01 normal, codebooks normal (the CPU tests' codec draws)."""
    import torch

    out = {}
    for k, v in module.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        u = torch.rand(v.shape, generator=gen, device=gen.device)
        n = torch.randn(v.shape, generator=gen, device=gen.device)
        out[k] = {"g": 0.3 + 0.4 * u, "alpha": 0.5 + u, "bias": 0.01 * n}.get(leaf, n)
    return out


def write_training_wavs(root, sr, n_train=12, n_val=4, seconds=12.0):
    """n_train + n_val WAVs of `seconds` at `sr`: two partials (50-500 Hz
    apart per file) and noise, from SEED, well above the -30 LUFS gate."""
    import numpy as np

    from vampnet_tpu_torch.audio import AudioSignal

    rng = np.random.default_rng(SEED)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n_train + n_val):
        split = "train" if i < n_train else "val"
        f0 = 80.0 + 37.0 * i
        wav = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 2.5 * f0 * t)
               + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        (root / split).mkdir(parents=True, exist_ok=True)
        AudioSignal(wav[None, None, :], sr).write(root / split / f"{i:02d}.wav")


def codec_options(codec_cfg, state):
    """The b=2 x 10 s encode and decode under each codec option: card ms
    (median of CUDA events), the share of codes that differ from fp32/xla,
    and the decoded audio's relative error against fp32/xla's decode of the
    same codes."""
    import dataclasses

    import torch

    from vampnet_tpu_torch.codec import LAC

    audio = train_audio(codec_cfg.sample_rate, codec_cfg.hop_length, 10.0, 2)
    options = {"fp32/xla": {}, "fp32/matmul": dict(conv_impl="matmul"),
               "bf16/xla": dict(compute_dtype="bfloat16"),
               "bf16/matmul": dict(compute_dtype="bfloat16", conv_impl="matmul"),
               "decoder-bf16/xla": dict(decoder_compute_dtype="bfloat16")}
    out, ref_codes, ref_wav = {}, None, None
    for name, opts in options.items():
        codec = LAC(dataclasses.replace(codec_cfg, **opts), device="meta")
        codec = codec.to_empty(device="cuda").requires_grad_(False)
        codec.load_state_dict(state)
        with torch.no_grad():
            codes = codec.encode(audio)
            if ref_codes is None:
                ref_codes = codes
            wav = codec.decode_codes(ref_codes)
            if ref_wav is None:
                ref_wav = wav
            enc_ms = time_ms(lambda: codec.encode(audio), reps=5)
            dec_ms = time_ms(lambda: codec.decode_codes(ref_codes), reps=5)
        if not bool(torch.isfinite(wav).all()) or wav.shape != ref_wav.shape:
            raise AssertionError(f"codec {name}: decoded {tuple(wav.shape)}, finite "
                                 f"{bool(torch.isfinite(wav).all())}")
        out[name] = dict(encode_ms=enc_ms, decode_ms=dec_ms,
                         codes_differ=float((codes != ref_codes).float().mean()),
                         audio_rel_err=rel_err(wav, ref_wav))
        print(f"trainer codec {name}: " + json.dumps(out[name]))
        del codec
    if len(torch.unique(ref_codes)) < min(64, codec_cfg.codebook_size // 2):
        raise AssertionError("the codec's codes are degenerate: the comparison says nothing")
    if out["decoder-bf16/xla"]["codes_differ"] != 0.0:
        raise AssertionError("the decoder's dtype changed the codes")
    return out


def trainer_phase(codec_cfg, sig, kw, n_samples, gen):
    """Phase 14: the trainer on the card. Writes synthetic WAVs and a
    random-weight codec into a temporary directory, then runs the codec
    options, the training loop from configs/vampnet.yml (4 steps with
    validation, samples and checkpoints, then a resume to step 6), the
    trained LM served from its model.vtpu, the c2f loop (configs/c2f.yml),
    a LoRA fine-tune (configs/lora/lora.yml) from a coarse .vtpu, and the
    step's options (bf16 moments, remat, encode_microbatch). Returns the
    phase's summary and the launches of K1, K4, K8 and K10 per unit."""
    import dataclasses
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vampnet_tpu_torch import config as cfglib
    from vampnet_tpu_torch.checkpoints import load_lm, save_codec
    from vampnet_tpu_torch.codec import LAC
    from vampnet_tpu_torch.convert import lm_state_dict_from_jax
    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.ops import flash_attention as fa
    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_from_logits
    from vampnet_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from vampnet_tpu_torch.train import loop as loop_mod
    from vampnet_tpu_torch.util import unflatten_tree

    t_phase = time.perf_counter()
    counters = {"attention_fwd": fa.flash_attention_with_bias,
                "attention_fwd_lse": fa.attention_fwd_lse,
                "attention_bwd_fused": fa.attention_bwd_fused,
                "sampler": fused_sample_from_logits}
    coarse, c2f = LMConfig.coarse(), LMConfig.c2f()
    n_coarse = sum(v.numel() for v in VampNetLM(coarse, device="meta").state_dict().values())
    # a coarse tag: fp32 params and two moments, model.vtpu; latest and best
    # with a preserved state.prev each while a save runs; a margin
    need = 1.25 * 2 * n_coarse * 4 * (4 + 3)
    summary = {"card": card_line()}

    def launches():
        return {n: c.launches for n, c in counters.items()}

    def reset():
        for c in counters.values():
            c.launches = 0

    @contextlib.contextmanager
    def per_unit(units):
        """Within the block, each call of the loop's train step, validate()
        and save_samples() appends the counters' change across it to
        units["step"], units["validation"] and units["sample_generation"]."""
        orig = {n: getattr(loop_mod, n) for n in ("validate", "save_samples", "make_train_step")}

        def counted(kind, fn):
            def call(*a, **k):
                before = launches()
                out = fn(*a, **k)
                after = launches()
                units[kind].append({n: after[n] - before[n] for n in after})
                return out
            return call

        loop_mod.validate = counted("validation", orig["validate"])
        loop_mod.save_samples = counted("sample_generation", orig["save_samples"])
        loop_mod.make_train_step = lambda *a, **k: counted(
            "step", orig["make_train_step"](*a, **k))
        try:
            yield
        finally:
            for n, f in orig.items():
                setattr(loop_mod, n, f)

    # the kernels at the shapes the loops give them that no earlier phase
    # holds against the plain versions (untimed, outside the counted runs):
    # K4/K8 at the c2f step's (b=8, 3 s) and the fine-tune's (lora.yml's
    # batch, 10 s); K1 with the training LM's fp32 bias at validation's
    # batch and at the sample generation's 4 rows; K10 at the sample
    # generation's rows. Their inputs come from a generator of their own, so
    # that the phase's weights are drawn as without them
    check_gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    sr, hop = codec_cfg.sample_rate, codec_cfg.hop_length
    t_of = {conf: math.ceil(float(cfglib.load_config(conf)["AudioDataset.duration"]) * sr / hop)
            for conf in ("configs/vampnet.yml", "configs/c2f.yml")}
    t_coarse, t_c2f = t_of["configs/vampnet.yml"], t_of["configs/c2f.yml"]
    b_val = int(cfglib.load_config("configs/vampnet.yml")["batch_size"])
    b_lora = int(cfglib.load_config("configs/lora/lora.yml")["batch_size"])
    d_head = coarse.embedding_dim // coarse.n_heads
    shape_checks = {}
    for label, b, t, h in ((f"c2f_step b=8 t={t_c2f}", 8, t_c2f, c2f.n_heads),
                           (f"lora_step b={b_lora} t={t_coarse}", b_lora, t_coarse,
                            coarse.n_heads)):
        for name, r in check_attention_train(b, t, h, d_head, check_gen, timed=False).items():
            shape_checks.setdefault(name, {})[label] = r["max_abs_err"]
    for label, b in ((f"validation b={b_val} t={t_coarse} fp32 bias", b_val),
                     (f"sample_generation b=4 t={t_coarse} fp32 bias", 4)):
        shape_checks.setdefault("attention_fwd", {})[label] = check_attention(
            b, t_coarse, coarse.n_heads, d_head, torch.float32, check_gen,
            timed=False)["max_abs_err"]
    flat = t_coarse * coarse.n_predict_codebooks
    logits = torch.randn((4, flat, 1024), generator=check_gen, device="cuda") * 3.0
    keys = torch.randint(0, 2 ** 32, (4, 2), generator=check_gen, device="cuda",
                         dtype=torch.int64)
    agree = sampler_agreement("trainer samples", keys, logits, torch.ones(4, device="cuda"),
                              typical_filtering=True, typical_mass=0.15, typical_min_tokens=64)
    shape_checks["sampler"] = {f"sample_generation b=4 flat={flat}":
                               max(agree["greedy_max_abs_err"], agree["noisy_max_abs_err"])}
    del logits, keys
    print("trainer kernel checks: " + json.dumps(shape_checks))
    summary["max_abs_err_trainer_shapes"] = shape_checks

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        root = Path(tmp)
        free = shutil.disk_usage(root).free
        if free < need:
            raise AssertionError(f"phase 14 needs {need / 2 ** 30:.1f} GiB free in {root}, "
                                 f"which has {free / 2 ** 30:.1f} GiB")
        summary["disk_free_gib"] = free / 2 ** 30
        write_training_wavs(root / "audio", codec_cfg.sample_rate)
        codec_state = codec_weights(LAC(codec_cfg, device="meta"), gen)
        save_codec(root / "codec.vtpu", codec_cfg,
                   unflatten_tree({tuple(k.split(".")): v.cpu() for k, v in codec_state.items()}))

        # ---- 14.1: the codec's compute options ----
        summary["codec_options"] = codec_options(codec_cfg, codec_state)

        common = {"codec_ckpt": str(root / "codec.vtpu"), "save_iters": [],
                  "train/AudioLoader.sources": [str(root / "audio" / "train")],
                  "val/AudioLoader.sources": [str(root / "audio" / "val")],
                  "train/AudioDataset.n_examples": 96, "val/AudioDataset.n_examples": 32}

        def run(label, conf, **over):
            """train() from `conf` with `over`; checks the launches of each
            train step (K4 = K8 = n_layers), validation (K1 4 n_layers: 4
            batches) and sample generation (K1 12 n_layers, K10 12: 12
            MaskGIT steps), each measured across its call, and that no
            launch fell outside them; returns (state, summary)."""
            args = {**cfglib.load_config(conf), **common, **over}
            stats = {}
            units = {"step": [], "validation": [], "sample_generation": []}
            reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with per_unit(units):
                state = loop_mod.train(args, device="cuda", stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            made = launches()
            steps = len(stats["step_s"])
            n_layers = state.model.config.n_layers
            res = dict(conf=conf, wall_s=wall, steps=steps, launches=made,
                       launches_per_unit=units,
                       step_ms=[s * 1e3 for s in stats["step_s"]],
                       loader_wait_ms=[s * 1e3 for s in stats["loader_wait_s"]],
                       save_s=stats["save_s"], val_ms=[s * 1e3 for s in stats["val_s"]],
                       sample_ms=[s * 1e3 for s in stats["sample_s"]],
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            print(f"trainer {label}: " + json.dumps(res))
            none = dict.fromkeys(counters, 0)
            want = {"step": dict(none, attention_fwd_lse=n_layers, attention_bwd_fused=n_layers),
                    "validation": dict(none, attention_fwd=4 * n_layers),
                    "sample_generation": dict(none, attention_fwd=12 * n_layers, sampler=12)}
            n_units = {"step": steps, "validation": len(stats["val_s"]),
                       "sample_generation": len(stats["sample_s"])}
            for kind, got in units.items():
                if len(got) != n_units[kind] or any(u != want[kind] for u in got):
                    raise AssertionError(f"trainer {label}: launches per {kind} {got}, "
                                         f"want {n_units[kind]} x {want[kind]}")
            outside = {n: made[n] - sum(u[n] for us in units.values() for u in us) for n in made}
            if any(outside.values()):
                raise AssertionError(f"trainer {label}: launches outside the steps, "
                                     f"validations and samples: {outside}")
            return state, res

        # ---- 14.2: the coarse loop, then a resume to step 6 ----
        coarse_run = root / "run_coarse"
        loop = dict(save_path=str(coarse_run), batch_size=8, num_iters=4, val_freq=2,
                    sample_freq=4, num_workers=4)
        # (the run's state is dropped at once: held, it would count in the
        # next run's peak)
        summary["coarse"] = run("coarse", "configs/vampnet.yml", **loop)[1]
        state, summary["coarse_resume"] = run("coarse resume", "configs/vampnet.yml",
                                              **dict(loop, num_iters=6, resume=True))
        if state.step != 6 or summary["coarse_resume"]["steps"] != 2:
            raise AssertionError(f"the resume ended at step {state.step}")
        lines = [json.loads(x) for x in (coarse_run / "metrics.jsonl").read_text().splitlines()]
        losses = [x["loss"] for x in lines if x["label"] == "train"]
        if len(losses) != 6 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"coarse loop losses {losses}")
        for tag in ("latest", "best"):
            for f in ("state/state.pt", "model.vtpu", "tracker.json"):
                if not (coarse_run / tag / f).exists():
                    raise AssertionError(f"coarse loop wrote no {tag}/{f}")
        summary["coarse"]["train_losses"] = losses
        summary["checkpoint_gib"] = {f: file_gib(coarse_run / "latest" / f)
                                     for f in ("state/state.pt", "model.vtpu")}
        for name in ("reconstructed", "inpainted_prompt", "inpainted_middle"):
            if len(list((coarse_run / "samples" / "step_4" / name).glob("*.wav"))) != 4:
                raise AssertionError(f"coarse loop wrote no {name} samples")
        base = root / "coarse.vtpu"
        shutil.copyfile(coarse_run / "latest" / "model.vtpu", base)
        del state
        shutil.rmtree(coarse_run)

        # ---- 14.3: the c2f loop, 2 steps at b=8 x 3 s ----
        c2f_run = root / "run_c2f"
        summary["c2f"] = run("c2f", "configs/c2f.yml", save_path=str(c2f_run), batch_size=8,
                             num_iters=2, val_freq=0, sample_freq=0, num_workers=4)[1]

        # ---- 14.4: the trained files served through Interface.from_checkpoints ----
        iface = Interface.from_checkpoints(coarse_ckpt=base, codec_ckpt=root / "codec.vtpu",
                                           coarse2fine_ckpt=c2f_run / "latest" / "model.vtpu",
                                           device="cuda")
        want = {"attention_fwd": 12 * coarse.n_layers + 2 * c2f.n_layers, "sampler": 14}
        summary["served"], _ = serve(
            "trained files", lambda i: iface.vamp_e2e(sig, seed=SEED + i, **kw), 1,
            {k: counters[k] for k in want}, want, n_samples)
        del iface
        shutil.rmtree(c2f_run)

        # ---- 14.5: a LoRA fine-tune from the coarse .vtpu ----
        ft_run = root / "run_lora"
        ft_state, summary["lora"] = run("lora fine-tune", "configs/lora/lora.yml",
                                        save_path=str(ft_run),
                                        num_iters=2, val_freq=0, sample_freq=0,
                                        init_ckpt=str(base))
        cfg, tree = load_lm(base)
        base_sd = lm_state_dict_from_jax(tree, dataclasses.replace(cfg, lora_r=8))
        sd = ft_state.model.state_dict()
        frozen_changed = [k for k in base_sd if not torch.equal(sd[k].cpu(), base_sd[k])]
        adapters_moved = sum(bool(v.abs().sum() > 0) for k, v in sd.items()
                             if k.endswith("lora_b"))
        if frozen_changed or adapters_moved != 5 * coarse.n_layers:
            raise AssertionError(f"lora fine-tune: frozen leaves changed {frozen_changed[:5]}, "
                                 f"{adapters_moved} adapters moved")
        if not (ft_run / "latest" / "lora.vtpu").exists():
            raise AssertionError("the fine-tune wrote no lora.vtpu")
        summary["lora"].update(adapters_moved=adapters_moved,
                               lora_vtpu_mib=file_gib(ft_run / "latest" / "lora.vtpu") * 1024)
        del ft_state, sd
        shutil.rmtree(ft_run)

    # ---- 14.6: the step's options at coarse b=8 ----
    codec = LAC(codec_cfg, device="meta").to_empty(device="cuda").requires_grad_(False)
    codec.load_state_dict(codec_state)
    cbs = codec.codebook_tables()[: coarse.n_codebooks].detach()
    options = {}
    for label, batch, opt_kw, cfg_kw, mb in (
            ("fp32 moments", 8, {}, {}, None),
            ("bf16 moments", 8, dict(state_dtype="bfloat16"), {}, None),
            ("remat b=8", 8, {}, dict(remat=True), None),
            ("remat b=16", 16, {}, dict(remat=True), None),
            ("encode_microbatch 2", 8, {}, {}, 2)):
        cfg = LMConfig.coarse(dropout=0.1, **cfg_kw)
        lm = VampNetLM(cfg, device="meta").to_empty(device="cuda")
        lm.load_state_dict(random_state(lm, gen))
        opt = make_optimizer(cfg.embedding_dim, **opt_kw)
        state = TrainState.create(lm, opt)
        step = make_train_step(lm, codec, opt, encode_microbatch=mb)
        audio = train_audio(codec_cfg.sample_rate, codec_cfg.hop_length, 10.0, batch)
        dgen = torch.Generator(device="cuda").manual_seed(SEED)
        fwd_per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
        want = {"attention_fwd": 0, "attention_fwd_lse": fwd_per_step,
                "attention_bwd_fused": cfg.n_layers, "sampler": 0}
        walls, made = [], []
        for i in range(4):
            reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, cbs, audio, dgen)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            made.append(launches())
            if not math.isfinite(loss):
                raise AssertionError(f"{label} step {i}: loss {loss}")
            if made[-1] != want:
                raise AssertionError(f"{label} step {i}: launches {made[-1]}, want {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        res = dict(batch=batch, step_ms=walls, median_ms_after_first=sorted(walls[1:])[1],
                   peak_gib=peak, launches_per_step=made)
        if mb:
            with torch.no_grad():
                full = codec.encode(audio)
                parts = torch.cat([codec.encode(a) for a in audio.split(mb)])
            res["codes_differ_from_full_encode"] = float((full != parts).float().mean())
        if opt_kw:
            res["moments_dtype"] = str(state.opt_state.mu[0].dtype)
        options[label] = res
        print(f"trainer step option {label}: " + json.dumps(res))
        del lm, state, step, opt
    summary["step_options"] = options

    def measured(run, kind, name):
        return [u[name] for u in run["launches_per_unit"][kind]]

    coarse_runs = (summary["coarse"], summary["coarse_resume"])
    summary["launches"] = {
        "attention_fwd": dict(
            coarse_loop=summary["coarse"]["launches"]["attention_fwd"],
            per_validation=measured(summary["coarse"], "validation", "attention_fwd"),
            per_sample_generation=measured(summary["coarse"], "sample_generation",
                                           "attention_fwd"),
            served_request=summary["served"]["launches_per_request"]["attention_fwd"]),
        "sampler": dict(
            coarse_loop=summary["coarse"]["launches"]["sampler"],
            per_sample_generation=measured(summary["coarse"], "sample_generation", "sampler"),
            served_request=summary["served"]["launches_per_request"]["sampler"]),
    }
    for name in ("attention_fwd_lse", "attention_bwd_fused"):
        summary["launches"][name] = dict(
            per_coarse_step=[x for r in coarse_runs for x in measured(r, "step", name)],
            per_c2f_step=measured(summary["c2f"], "step", name),
            per_lora_step=measured(summary["lora"], "step", name),
            per_remat_step=[m[name] for m in options["remat b=8"]["launches_per_step"]])
    summary["phase_s"] = time.perf_counter() - t_phase
    print("trainer phase: " + json.dumps(summary))
    return summary


def write_reference_codec(path, codec):
    """Write a codec as upstream's `lac` saves one, from the port's `LAC`:
    DAC's nested Sequential names, weight norm as (weight_g, weight_v) with
    g (C, 1, 1), snake alphas (1, C, 1), the audiotools wrapper with the
    sample rate in its metadata (the inverse of `codec/convert.py`)."""
    import torch

    cfg = codec.config
    flat = {tuple(k.split(".")): v.detach().cpu() for k, v in codec.state_dict().items()}
    sd = {}

    def wn(p, base):
        sd[f"{base}.weight_v"] = flat[p + ("v",)]
        sd[f"{base}.weight_g"] = flat[p + ("g",)].reshape(-1, 1, 1)
        if p + ("bias",) in flat:
            sd[f"{base}.bias"] = flat[p + ("bias",)]

    def snake(p, base):
        sd[f"{base}.alpha"] = flat[p + ("alpha",)].reshape(1, -1, 1)

    def res(p, base):
        snake(p + ("snake_1",), f"{base}.block.0")
        wn(p + ("conv_1",), f"{base}.block.1")
        snake(p + ("snake_2",), f"{base}.block.2")
        wn(p + ("conv_2",), f"{base}.block.3")

    wn(("encoder", "conv_in"), "encoder.block.0")
    n_enc, n_dec = len(cfg.encoder_rates), len(cfg.decoder_rates)
    for i in range(n_enc):
        p, base = ("encoder", f"block_{i}"), f"encoder.block.{i + 1}"
        for j in range(3):
            res(p + (f"res_{j + 1}",), f"{base}.block.{j}")
        snake(p + ("snake",), f"{base}.block.3")
        wn(p + ("conv",), f"{base}.block.4")
    snake(("encoder", "snake_out"), f"encoder.block.{n_enc + 1}")
    wn(("encoder", "conv_out"), f"encoder.block.{n_enc + 2}")
    for i in range(cfg.n_codebooks):
        p, base = ("quantizer", f"quantizers_{i}"), f"quantizer.quantizers.{i}"
        wn(p + ("in_proj",), f"{base}.in_proj")
        wn(p + ("out_proj",), f"{base}.out_proj")
        sd[f"{base}.codebook.weight"] = flat[p + ("codebook",)]
    wn(("decoder", "conv_in"), "decoder.model.0")
    for i in range(n_dec):
        p, base = ("decoder", f"block_{i}"), f"decoder.model.{i + 1}"
        snake(p + ("snake",), f"{base}.block.0")
        wn(p + ("conv_t",), f"{base}.block.1")
        for j in range(3):
            res(p + (f"res_{j + 1}",), f"{base}.block.{j + 2}")
    snake(("decoder", "snake_out"), f"decoder.model.{n_dec + 1}")
    wn(("decoder", "conv_out"), f"decoder.model.{n_dec + 2}")
    if len(sd) != len(flat):
        raise AssertionError(f"the codec's {len(flat)} tensors became {len(sd)} entries")
    torch.save({"state_dict": {k: v.contiguous() for k, v in sd.items()},
                "metadata": {"kwargs": {"sample_rate": cfg.sample_rate}}}, path)


def write_random_vggish(path, gen):
    """A torchvggish-layout state dict (`features.*`, `embeddings.*`) with
    He-normal weights, so activations stay of order 1 through the ReLUs, and
    biases of 0.01 normal, drawn from `gen`."""
    import torch

    from vampnet_tpu_torch.vggish import VGGish

    sd = {}
    for k, v in VGGish(device="meta").state_dict().items():
        x = torch.randn(v.shape, generator=gen)
        sd[k] = x * (2.0 / math.prod(v.shape[1:])) ** 0.5 if v.dim() > 1 else 0.01 * x
    torch.save(sd, path)


def busy_ms(fn):
    """The card's busy time over one call of fn: the summed durations of
    the device activities (kernels, copies, sets) that the profiler's CUDA
    tracing records, read from its raw events (`profile`'s `key_averages`
    over tens of thousands of launches takes tens of seconds). Returns (ms,
    activities)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no device activity")
    return sum(e.duration_ns() for e in dev) / 1e6, len(dev)


def entry_points_phase(codec_cfg, sig, kw, counters, want, n_samples, gen):
    """Phase 15: the entry points and the last single-card modules at full
    width, in a temporary directory: an upstream snapshot (`.pth` files; the
    codec with `codec_weights`, whose decoded audio follows its codes)
    through `scripts.convert_reference`, its `.vtpu` files served against
    the `.pth` files; `vamp_microbatched` on 40 s at group_chunks 4, 2 and 1
    against the one-shot staged run; the sampler's debug dumps;
    `scripts.exp.experiment` then `scripts.exp.eval` with the log-mel FAD
    and with VGGish on the card; `Interface.to`; `hello.main` on the
    converted models directory. Returns the phase's summary and K1 and
    K10 held against their plain versions at this phase's new shapes."""
    import importlib
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from vampnet_tpu_torch import hello, registry
    from vampnet_tpu_torch.audio import AudioSignal
    from vampnet_tpu_torch.checkpoints import load_codec
    from vampnet_tpu_torch.codec import LAC
    from vampnet_tpu_torch.codec.layers import no_tf32
    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.modules.lora import LORA_LEAVES, LORA_R
    from vampnet_tpu_torch.sampling.debug import save_debug_dumps
    from vampnet_tpu_torch.scripts.convert_reference import convert_reference
    from vampnet_tpu_torch.scripts.exp import experiment
    from vampnet_tpu_torch.scripts.exp.eval import evaluate
    from vampnet_tpu_torch.util import flatten_tree
    from vampnet_tpu_torch.vggish import VGGishEmbedder, waveform_to_examples

    t_phase = time.perf_counter()
    sys.modules["huggingface_hub"] = None  # nothing here may reach the network
    cfgs = {"coarse": LMConfig.coarse(lora_r=LORA_R), "c2f": LMConfig.c2f(lora_r=LORA_R)}
    sr, hop = codec_cfg.sample_rate, codec_cfg.hop_length
    n_layer_calls = want["attention_fwd"]
    cpu_gen = torch.Generator().manual_seed(SEED + 15)
    codec = LAC(codec_cfg, device="meta").to_empty(device="cpu")
    codec.load_state_dict(codec_weights(codec, cpu_gen))
    summary, seconds = {}, {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    def reset():
        for c in counters.values():
            c.launches = 0

    def launches():
        return {name: c.launches for name, c in counters.items()}

    # ---- 15.0: K1 and K10 at the shapes this phase gives them first ----
    t0 = time.perf_counter()
    d_head = cfgs["coarse"].embedding_dim // cfgs["coarse"].n_heads
    t_coarse, t_c2f = math.ceil(10 * sr / hop), math.ceil(3 * sr / hop)
    n_pred = {k: c.n_predict_codebooks for k, c in cfgs.items()}
    kernel_checks = {
        "attention_fwd": {f"b1_t{t_coarse}": check_attention(
            1, t_coarse, cfgs["coarse"].n_heads, d_head, torch.bfloat16, gen)},
        "sampler": {f"b1_{t_coarse * n_pred['coarse']}": check_sampler(
            1, t_coarse * n_pred["coarse"], gen)},
    }
    # the c2f rows of a group of 1, 2 and 4 coarse chunks (4, 7, 14 rows)
    for rows in (4, 7, 14):
        kernel_checks["attention_fwd"][f"b{rows}_t{t_c2f}"] = check_attention(
            rows, t_c2f, cfgs["c2f"].n_heads, d_head, torch.bfloat16, gen, timed=False)
        kernel_checks["sampler"][f"b{rows}_{t_c2f * n_pred['c2f']}"] = check_sampler(
            rows, t_c2f * n_pred["c2f"], gen)
    for name, res in kernel_checks.items():
        for shape, r in res.items():
            print(f"kernel {name}[{shape}] (phase 15): " + json.dumps(r))
    seconds["K1 and K10 checks"] = time.perf_counter() - t0

    n_params = sum(v.numel() for cfg in cfgs.values()
                   for v in VampNetLM(cfg, device="meta").state_dict().values())
    # the snapshot's fp32 .pth files and their fp32 .vtpu twins, twice (the
    # fine-tune), the codec; a margin
    need = 1.25 * 2 * 2 * 4 * n_params
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_points_") as tmp:
        root = Path(tmp)
        free = shutil.disk_usage(root).free
        if free < need:
            raise AssertionError(f"phase 15 needs {need / 2 ** 30:.1f} GiB free in {root}, "
                                 f"which has {free / 2 ** 30:.1f} GiB")

        # ---- 15.1: an upstream snapshot, converted by convert_reference ----
        snap, ft_name = root / "snapshot", "smoke_finetune"
        (snap / "loras" / ft_name).mkdir(parents=True)
        timed("write codec.pth", lambda: write_reference_codec(snap / "codec.pth", codec))
        for name, cfg in cfgs.items():
            st = lora_state(VampNetLM(cfg, device="meta"), cpu_gen)
            timed(f"write {name}.pth", lambda: write_reference_lm(snap / f"{name}.pth", st, cfg))
            ft = {k: (torch.randn(x.shape, generator=cpu_gen) * (
                      x.shape[0] ** -0.5 if k.endswith("lora_a") else 0.1)
                      if k.split(".")[-1] in LORA_LEAVES else x) for k, x in st.items()}
            write_reference_lm(snap / "loras" / ft_name / f"{name}.pth", ft, cfg)
            del st, ft
        write_random_wavebeat(snap / "wavebeat.pth", cpu_gen)
        zoo = timed("convert_reference", lambda: convert_reference(
            str(snap), out=str(root / "zoo"), device="cuda"))
        report = (zoo / "CONVERSION_REPORT.md").read_text()
        _, codec_tree = load_codec(zoo / "codec.vtpu")
        got = {".".join(k): v for k, v in flatten_tree(codec_tree).items()}
        if any(not torch.equal(got[k], v) for k, v in codec.state_dict().items()) or \
                len(got) != len(codec.state_dict()):
            raise AssertionError("codec.pth -> codec.vtpu changed the codec's weights")
        summary["convert_reference"] = dict(
            files=sorted(str(p.relative_to(zoo)) for p in zoo.rglob("*.vtpu")),
            report_lines=len(report.splitlines()),
            codec_smoke=[line.strip() for line in report.splitlines() if "distinct" in line])
        print("convert_reference report:\n" + report)

        # ---- 15.2: the .vtpu files serve the .pth files' tokens ----
        pth = timed("load .pth interface", lambda: Interface.from_checkpoints(
            coarse_ckpt=snap / "coarse.pth", coarse2fine_ckpt=snap / "c2f.pth",
            codec_ckpt=snap / "codec.pth", device="cuda"))
        pth_codes = record_codes(pth)
        served_pth, _ = serve("snapshot .pth", lambda i: pth.vamp_e2e(sig, seed=SEED, **kw), 1,
                              counters, want, n_samples)
        del pth
        torch.cuda.empty_cache()
        vt = timed("load converted .vtpu interface", lambda: Interface.from_checkpoints(
            coarse_ckpt=zoo / "coarse.vtpu", coarse2fine_ckpt=zoo / "c2f.vtpu",
            codec_ckpt=zoo / "codec.vtpu", wavebeat_ckpt=zoo / "wavebeat.vtpu", device="cuda"))
        vt_codes = record_codes(vt)
        served_vtpu, _ = serve("converted .vtpu", lambda i: vt.vamp_e2e(sig, seed=SEED, **kw), 1,
                               counters, want, n_samples)
        if not torch.equal(vt_codes[0], pth_codes[0]):
            raise AssertionError("the converted .vtpu files give other tokens than the .pth")
        summary["convert_reference"].update(
            vtpu_tokens_equal_pth=True, tokens_shape=list(vt_codes[0].shape),
            distinct_tokens=int(vt_codes[0].unique().numel()),
            first_tokens=vt_codes[0][0, :, :4].tolist())
        del vt.codec.decode_codes, pth_codes, vt_codes  # the codec's own decode again
        summary["served_pth"], summary["served_vtpu"] = served_pth, served_vtpu

        # ---- 15.3: vamp_microbatched on 40 s, 4 coarse chunks ----
        sig40 = bench_signal(sr, 40.0)
        z40 = vt.encode(sig40)
        mask40 = vt.build_mask(z40, periodic_prompt=7, upper_codebook_mask=3, seed=SEED)
        seeds = np.array([1234], np.uint32)
        mkw = dict(_sampling_steps=12, c2f_steps=2)
        t_micro = time.perf_counter()
        n_chunks = math.ceil(z40.shape[-1] / t_coarse)
        reset()
        t0 = time.perf_counter()
        one_shot = vt.coarse_to_fine(
            vt.coarse_vamp(z40, mask40, seed=seeds, _sampling_steps=12), mask=mask40,
            seed=(seeds + np.uint32(0x9E3779B9)).astype(np.uint32)).cpu().numpy()
        micro = dict(one_shot_wall_ms=(time.perf_counter() - t0) * 1e3,
                     one_shot_launches=launches(), t_tokens=int(z40.shape[-1]),
                     coarse_chunks=n_chunks, runs={})
        n_coarse = cfgs["coarse"].n_codebooks
        outs = {}
        for group in (4, 2, 1):
            n_groups = math.ceil(n_chunks / group)
            reset()
            t0 = time.perf_counter()
            out = vt.vamp_microbatched(z40, mask40, group_chunks=group, seed=seeds,
                                       **mkw).cpu().numpy()
            wall = (time.perf_counter() - t0) * 1e3
            made = launches()
            per_group = dict(want, attention_fwd=n_layer_calls * n_groups, sampler=14 * n_groups)
            if made != per_group:
                raise AssertionError(f"vamp_microbatched group_chunks={group}: launches {made}, "
                                     f"want {per_group}")
            if out.shape != tuple(z40.shape) or bool((out == vt.coarse.mask_token).any()):
                raise AssertionError(f"vamp_microbatched group_chunks={group}: output "
                                     f"{tuple(out.shape)} or MASK tokens left")
            busy, n_kernels = busy_ms(lambda: vt.vamp_microbatched(
                z40, mask40, group_chunks=group, seed=seeds, **mkw).cpu())
            outs[group] = out
            coarse_vs_one = token_share(out[:, :n_coarse], one_shot[:, :n_coarse])
            micro["runs"][f"group_chunks_{group}"] = dict(
                groups=n_groups, wall_ms=wall, busy_ms=busy, device_activities=n_kernels,
                launches=made, coarse_share_differing_from_one_shot=coarse_vs_one,
                all_share_differing_from_one_shot=token_share(out, one_shot))
            if coarse_vs_one > SOLO_BATCHED_BOUND:
                raise AssertionError(f"group_chunks={group}: {coarse_vs_one} of the coarse "
                                     f"tokens differ from the one-shot run")
        for group in (2, 1):
            share = token_share(outs[group][:, :n_coarse], outs[4][:, :n_coarse])
            micro["runs"][f"group_chunks_{group}"]["coarse_share_differing_from_4"] = share
            if share > SOLO_BATCHED_BOUND:
                raise AssertionError(f"group_chunks={group}: {share} of the coarse tokens "
                                     "differ from group_chunks=4")
        summary["vamp_microbatched"] = micro
        seconds["vamp_microbatched, 4 runs and 3 profiled"] = time.perf_counter() - t_micro
        print("vamp_microbatched: " + json.dumps(micro))
        del outs, one_shot

        # ---- 15.4: the sampler's per-step dumps ----
        z10 = vt.encode(sig)
        m10 = vt.build_mask(z10, periodic_prompt=7, upper_codebook_mask=3, seed=SEED)
        plain = vt.coarse_vamp(z10, m10, seed=SEED + 1)
        dumped = timed("coarse_vamp with save_debug_dumps", lambda: vt.coarse_vamp(
            z10, m10, seed=SEED + 1, debug_callback=save_debug_dumps(str(root / "debug"))))
        steps = sorted(p.name for p in (root / "debug").iterdir())
        state = np.load(root / "debug" / "step_11" / "state.npz")
        if steps != sorted(f"step_{i}" for i in range(12)) or not torch.equal(dumped, plain) \
                or any(not (root / "debug" / s / "state.npz").exists() for s in steps):
            raise AssertionError(f"debug dumps: {steps}, tokens equal {torch.equal(dumped, plain)}")
        summary["debug_dumps"] = dict(
            steps=len(steps), tokens_equal_without=True,
            pngs=len(list((root / "debug").rglob("*.png"))),
            arrays={k: list(state[k].shape) for k in state.files})

        # ---- 15.5: experiment, then eval with the log-mel FAD and VGGish ----
        src = root / "exp_src"
        src.mkdir()
        bench_signal(sr, 10.0).write(src / "bench.wav")
        beat_signal(sr, 10.0).write(src / "clicks.wav")
        conds = {"baseline": experiment.baseline, "reconstructed": experiment.reconstructed,
                 "coarse2fine": experiment.coarse2fine,
                 "steps_1": experiment.num_sampling_steps(1)}
        exp = timed("experiment", lambda: experiment.run_conditions(
            vt, [str(src)], root / "exp", conds, max_excerpts=2))
        fad = {}
        metrics = timed("eval log-mel", lambda: evaluate(str(exp), device="cuda"))
        fad["log_mel"] = {m["condition"]: m["frechet"] for m in metrics}
        stats_mel = (exp / "stats-mel.csv").read_text().splitlines()
        if len(stats_mel) != 4 or len((exp / "metrics-all.csv").read_text().splitlines()) != 7:
            raise AssertionError(f"eval CSVs: {stats_mel}")
        mel = {m["condition"]: [] for m in metrics}
        for m in metrics:
            mel[m["condition"]].append(m["mel"])
        mel = {k: float(np.mean(v)) for k, v in mel.items()}
        write_random_vggish(root / "vggish.pth", cpu_gen)
        metrics = timed("eval vggish", lambda: evaluate(
            str(exp), vggish_ckpt=str(root / "vggish.pth"), device="cuda"))
        fad["vggish"] = {m["condition"]: m["frechet"] for m in metrics}
        if not all(np.isfinite(v) for d in fad.values() for v in d.values()):
            raise AssertionError(f"FAD not finite: {fad}")
        card_emb = VGGishEmbedder(root / "vggish.pth", device="cuda")
        cpu_emb = VGGishEmbedder(root / "vggish.pth", device="cpu")
        examples = waveform_to_examples(sig.samples[0, 0], sr)
        e_card = card_emb.embed(examples)
        e_cpu = timed("VGGish on the CPU", lambda: cpu_emb.embed(examples))
        vggish_err = float(np.abs(e_card - e_cpu).max() / np.abs(e_cpu).max())
        x_card = torch.from_numpy(examples)[:, None].cuda()

        def vggish_forward():
            with torch.inference_mode(), no_tf32():
                return card_emb.model(x_card)

        # fp32 convolutions and products (TF32 off) in other orders
        if not vggish_err < 1e-3:
            raise AssertionError(f"VGGish on the card vs the CPU: rel err {vggish_err}")
        summary["experiment_eval"] = dict(
            conditions=sorted(conds), files=sorted(p.name for p in (exp / "baseline").iterdir()),
            mel_mean=mel, fad=fad, stats_mel_csv=stats_mel,
            reconstructed_below_steps_1=mel["reconstructed"] < mel["steps_1"],
            vggish_rel_err_card_vs_cpu=vggish_err, vggish_examples=int(examples.shape[0]),
            vggish_forward_ms=time_ms(vggish_forward))
        print("experiment and eval: " + json.dumps(summary["experiment_eval"]))

        # ---- 15.6: Interface.to ----
        for dev in ("cpu", "cuda"):
            timed(f"Interface.to({dev})", lambda: vt.to(dev))
            tensors = [*vt.codec.parameters(), *vt.coarse.parameters(), *vt.c2f.parameters(),
                       vt.codebooks, *vt.beat_tracker.model.model.parameters()]
            if vt.device.type != dev or any(t.device.type != dev for t in tensors):
                raise AssertionError(f"Interface.to({dev}) left a tensor elsewhere")
        summary["served_after_to"], _ = serve(
            "after to(cpu), to(cuda)", lambda i: vt.vamp_e2e(sig, seed=SEED, **kw), 1,
            counters, want, n_samples)
        del vt
        torch.cuda.empty_cache()

        # ---- 15.7: hello.main on the converted models directory ----
        os.environ["VAMPNET_MODELS_DIR"] = str(zoo)
        importlib.reload(registry)
        asset = AudioSignal("assets/example.wav")
        reset()
        out = timed("hello.main", lambda: hello.main(out=str(root / "hello.wav"),
                                                     device="cuda"))
        made = launches()
        wav = AudioSignal(root / "hello.wav")
        frames = math.ceil(asset.length * sr / asset.sample_rate / hop)
        if wav.length != frames * hop or not np.isfinite(wav.samples).all() or \
                made != want:
            raise AssertionError(f"hello.main wrote {wav.length} samples (want {frames * hop}), "
                                 f"launches {made}")
        summary["hello"] = dict(input_samples=asset.length, output_samples=wav.length,
                                sample_rate=wav.sample_rate, launches=made,
                                peak=float(np.abs(out.samples).max()))
    summary["seconds"] = seconds
    summary["phase_s"] = time.perf_counter() - t_phase
    print("entry points phase: " + json.dumps(summary))
    return summary, kernel_checks


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
    from vampnet_tpu_torch.ops import flash_attention as fa
    from vampnet_tpu_torch.ops.ffn_kernel import fused_geglu_ffn
    from vampnet_tpu_torch.ops.flash_attention import flash_attention_with_bias
    from vampnet_tpu_torch.ops.int8_matmul import w8a8_matmul
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
        if "error" in line or "Performance Loss" in line:
            print(f"build: {line.strip()}")
    for name, (regs, spill_st, spill_ld) in kernel_registers().items():
        print(f"build: {regs:3d} registers, spills {spill_st}/{spill_ld} B  {name}")
    # the forward's 16 instances (D, bf16 bias, lse, mask): the count is per
    # thread at launch; setmaxnreg then moves registers from the producer
    # warpgroup to the two consumer warpgroups
    fwd_regs = registers_of("attention_fwd_kernel")
    if len(fwd_regs) != 16:
        raise AssertionError(f"expected 16 attention forward instances, found {sorted(fwd_regs)}")
    for name, (regs, spill_st, spill_ld) in fwd_regs.items():
        print(f"build: attention forward {name.split()[-1]}: {regs} registers, spills "
              f"{spill_st}/{spill_ld} B")
    # the backward's 8 instances (D, bf16 bias, mask), set up the same way
    bwd_regs = registers_of("attention_bwd_kernel")
    if len(bwd_regs) != 8:
        raise AssertionError(f"expected 8 attention backward instances, found {sorted(bwd_regs)}")

    # ---- 3. kernels against their plain versions ----
    codec_cfg, coarse_cfg, c2f_cfg = CodecConfig(), LMConfig.coarse(), LMConfig.c2f()
    hop, sr = codec_cfg.hop_length, codec_cfg.sample_rate
    t_coarse, t_c2f = math.ceil(10 * sr / hop), math.ceil(3 * sr / hop)
    n_c2f_rows = 2 * math.ceil(t_coarse / t_c2f)
    d_model = coarse_cfg.embedding_dim
    d_head = d_model // coarse_cfg.n_heads
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    checks = {
        ("attention_fwd", "coarse"): lambda: check_attention(
            2, t_coarse, coarse_cfg.n_heads, d_head, torch.bfloat16, gen),
        ("attention_fwd", "c2f"): lambda: check_attention(
            n_c2f_rows, t_c2f, c2f_cfg.n_heads, d_head, torch.bfloat16, gen),
        ("attention_fwd", "coarse_fp32_bias"): lambda: check_attention(
            2, t_coarse, coarse_cfg.n_heads, d_head, torch.float32, gen),
        # head dims the JAX wrapper pads to 128 lanes: d_model kept, heads varied
        ("attention_fwd", "d32"): lambda: check_attention(
            2, t_coarse, d_model // 32, 32, torch.bfloat16, gen, timed=False),
        ("attention_fwd", "d128"): lambda: check_attention(
            2, t_coarse, d_model // 128, 128, torch.bfloat16, gen, timed=False),
        ("sampler", "coarse"): lambda: check_sampler(
            2, t_coarse * coarse_cfg.n_predict_codebooks, gen, cases=True),
        ("sampler", "c2f"): lambda: check_sampler(
            n_c2f_rows, t_c2f * c2f_cfg.n_predict_codebooks, gen),
    }
    # the w8a8 kernel at every projection shape of both LMs (m = b t)
    m_rows = {"coarse": 2 * t_coarse, "c2f": n_c2f_rows * t_c2f}
    proj = {"qkvfc": (d_model, d_model), "w_1": (d_model, 4 * d_model),
            "w_2": (2 * d_model, d_model)}
    for lm_name, m in m_rows.items():
        for site, (k, n) in proj.items():
            checks[("w8a8_matmul", f"{lm_name}_{site}")] = (
                lambda m=m, k=k, n=n: check_w8a8(m, k, n, gen))
        checks[("fused_geglu_ffn", lm_name)] = lambda m=m: check_ffn(m, d_model, gen)
    checks[("w8a8_matmul", "ragged")] = lambda: check_w8a8_ragged(gen)
    checks[("fused_geglu_ffn", "edges")] = lambda: check_ffn_edges(gen)
    # the long-context and masked routes: the app's 11 s chunk (948 tokens,
    # K1 where JAX takes K3 without a mask) and 12-20 s chunks (K9); the
    # masked forward (K3) at the coarse serving shape and, past 1024, K9's
    t_long = math.ceil(20 * sr / hop)  # 1,723
    for t in (math.ceil(11 * sr / hop), 1034, t_long, 2048):
        route = "attention_fwd" if t <= 1024 else "attention_fwd_long"
        checks[(route, f"t{t}")] = lambda t=t: check_attention(
            2, t, coarse_cfg.n_heads, d_head, torch.bfloat16, gen)
    checks[("attention_fwd_masked", "coarse")] = lambda: check_attention(
        2, t_coarse, coarse_cfg.n_heads, d_head, torch.bfloat16, gen,
        mask=random_mask(2, t_coarse, gen))
    checks[("attention_fwd_long", "masked_t2048")] = lambda: check_attention(
        2, 2048, coarse_cfg.n_heads, d_head, torch.bfloat16, gen, mask=random_mask(2, 2048, gen))
    checks[("sampler", f"long_t{t_long}")] = lambda: check_sampler(
        2, t_long * coarse_cfg.n_predict_codebooks, gen)
    results = {"attention_fwd": {}, "attention_fwd_masked": {}, "attention_fwd_long": {},
               "sampler": {}, "w8a8_matmul": {}, "fused_geglu_ffn": {}}
    for (name, shape), check in checks.items():
        results[name][shape] = check()
        print(f"kernel {name}[{shape}]: " + json.dumps(results[name][shape]))
    attn, samp = results["attention_fwd"], results["sampler"]
    # the GEMM's 4 tile widths (BN), set up like the attention kernels
    w8a8_regs = registers_of("w8a8_wgmma_kernel")
    if len(w8a8_regs) != 4:
        raise AssertionError(f"expected 4 w8a8 GEMM instances, found {sorted(w8a8_regs)}")
    w8a8_regs.update(registers_of("row_quant_kernel"))
    # the fused FFN's two GEMMs at their 6 tile widths (up-projection BN 112,
    # 128, 160; down-projection 128, 144, 192), set up like the w8a8 GEMM,
    # and its RMSNorm row pass (bf16 and fp32 norm weights)
    ffn_regs = registers_of("ffn_gemm_kernel")
    if len(ffn_regs) != 6:
        raise AssertionError(f"expected 6 fused FFN GEMM instances, found {sorted(ffn_regs)}")
    ffn_regs.update(registers_of("rms_norm_kernel"))
    sampler_regs = registers_of("sampler_kernel")
    # the training kernels at the coarse training shape, and once at b=16,
    # where the JAX package takes its split backward pair (K6/K7)
    train_k = check_attention_train(TRAIN_BATCH, t_coarse, coarse_cfg.n_heads, d_head, gen)
    train_k16 = check_attention_train(16, t_coarse, coarse_cfg.n_heads, d_head, gen, timed=False)
    for name in train_k:
        print(f"kernel {name}[train b={TRAIN_BATCH}]: " + json.dumps(train_k[name]))
        print(f"kernel {name}[train b=16]: " + json.dumps(train_k16[name]))
    # the masked training kernels at the coarse training shape with a
    # key-padding mask, and the unmasked ones at b=1, t=2048, where JAX's
    # "auto" would take XLA and the port takes the kernels
    valid = (t_coarse, 700, 431, 100)
    masked_k = check_attention_train(TRAIN_BATCH, t_coarse, coarse_cfg.n_heads, d_head, gen,
                                     mask=key_padding_mask(TRAIN_BATCH, t_coarse, valid))
    train_k2048 = check_attention_train(1, 2048, coarse_cfg.n_heads, d_head, gen)
    for name in masked_k:
        print(f"kernel {name}[train b={TRAIN_BATCH} key padding]: " + json.dumps(masked_k[name]))
    for name in train_k2048:
        print(f"kernel {name}[train b=1 t=2048]: " + json.dumps(train_k2048[name]))
    # the training kernels at the other head dims and with the serving LMs'
    # bf16 bias
    for label, kw in (("d32", dict(h=d_model // 32, d=32)),
                      ("d128", dict(h=d_model // 128, d=128)),
                      ("bf16_bias", dict(h=coarse_cfg.n_heads, d=d_head,
                                         bias_dtype=torch.bfloat16))):
        res = check_attention_train(2, t_coarse, gen=gen, timed=False, **kw)
        for name in res:
            print(f"kernel {name}[train b=2 {label}]: " + json.dumps(res[name]))

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
    n_samples = t_coarse * hop
    n_layer_calls = 12 * coarse_cfg.n_layers + 2 * c2f_cfg.n_layers  # 272
    counters = {"attention_fwd": flash_attention_with_bias, "sampler": fused_sample_from_logits,
                "w8a8_matmul": w8a8_matmul, "fused_geglu_ffn": fused_geglu_ffn}
    want = {"attention_fwd": n_layer_calls, "sampler": 12 + 2, "w8a8_matmul": 0,
            "fused_geglu_ffn": 0}
    served, base_launches = serve("bf16", lambda i: iface.vamp_e2e(sig, seed=SEED + i, **kw),
                                  REQUESTS, counters, want, n_samples)
    launches = {"attention_fwd": base_launches["attention_fwd"],
                "sampler": base_launches["sampler"]}

    # ---- 5. full-width training steps ----
    train, train_launches = train_full_width(iface.codec, iface.codebooks, gen)
    launches.update(train_launches)

    # ---- 6. the card against the CPU on small inputs ----
    print("cpu check: " + json.dumps(check_against_cpu(iface, gen)))
    print("cpu check: " + json.dumps(check_train_against_cpu(gen)))

    # ---- 7. where a request's time goes ----
    # nvjet: cuBLAS's GEMMs (the LMs' projections and classifiers)
    busy_bf16, launches_bf16 = profile("request", lambda: iface.vamp_e2e(sig, seed=99, **kw),
                        totals=("nvjet", "sampler_kernel"))

    # ---- 8. long-context requests through the staged API ----
    # the Gradio app's sequence with a 20 s coarse chunk on a 20 s signal
    # (t = 1,723: K9), then an 11 s chunk on a 10 s signal (t = 948, one
    # padded chunk: K1 where JAX takes K3 without a mask)
    sig20 = bench_signal(sr, 20.0)
    long_counters = dict(counters, attention_fwd_long=fa.attention_fwd_long,
                         attention_fwd_masked=fa.attention_fwd_masked)
    base_want = dict.fromkeys(long_counters, 0)
    want20 = dict(base_want, attention_fwd=2 * c2f_cfg.n_layers,
                  attention_fwd_long=12 * coarse_cfg.n_layers, sampler=12 + 2)
    served_long, long_launches = serve(
        "long 20 s", lambda i: staged_request(iface, sig20, 20, SEED + i), LONG_REQUESTS,
        long_counters, want20, t_long * hop)
    launches["attention_fwd_long"] = long_launches["attention_fwd_long"]
    want11 = dict(base_want, attention_fwd=n_layer_calls, sampler=12 + 2)
    served_11, _ = serve("long 11 s chunk", lambda i: staged_request(iface, sig, 11, SEED + i),
                         1, long_counters, want11, n_samples)
    profile("long request", lambda: staged_request(iface, sig20, 20, 97))
    iface.set_chunk_size(10)

    # ---- 8b. the serving engine and the web app (the Interface still bf16) ----
    engine_phase, engine_group = serve_engine_and_webapp(iface, sig, counters, card)

    # ---- 8c. the request options: top_k (K10) and cfg_guidance, sketch2sound
    # controls, the onset and beat masks (the Interface still bf16) ----
    t0 = time.perf_counter()
    topk_k10 = check_sampler_top_k(gen)
    # K1 at the doubled batch that a cfg_guidance request's coarse stage and
    # the controls' CFG forwards give it: 2 rows and their unconditional twins
    # (untimed, outside the counted runs)
    option_k1 = dict(check_attention(4, t_coarse, coarse_cfg.n_heads, d_head, torch.bfloat16,
                                     gen, timed=False),
                     shape=f"b=4 t={t_coarse} h={coarse_cfg.n_heads} d={d_head}")
    print("kernel attention_fwd at the doubled batch: " + json.dumps(option_k1))
    options = dict(staged=staged_options(iface, sig, counters, want, n_samples))
    options["controls"] = controls_full_width(iface, sig, gen)
    options["controller_train"] = train_controller(iface.codec, iface.codebooks, gen)
    options["masks"] = masks_and_beats(iface, counters, want, gen)
    options["cpu_check"] = check_option_lms_against_cpu(gen)
    print("cpu check: " + json.dumps(options["cpu_check"]))
    options["phase_s"] = time.perf_counter() - t0
    print(f"options phase: {options['phase_s']:.1f} s")

    # ---- 9. a full-width masked TransformerStack, forward and backward ----
    masked_stack, masked_launches = masked_stack_full_width(gen, t_coarse, valid)
    launches.update(masked_launches)
    print("cpu check: " + json.dumps(check_small_lms_against_cpu(gen)))

    # ---- 10. the fused-FFN option: same weights, ffn_impl="fused" ----
    fused_iface = fused_interface(iface)
    ffn_calls = [0]
    hooks = [m.register_forward_pre_hook(lambda *_: ffn_calls.__setitem__(0, ffn_calls[0] + 1))
             for lm in (fused_iface.coarse, fused_iface.c2f)
             for name, m in lm.named_modules()
             if name.endswith(("feed_forward.w_1", "feed_forward.w_2"))]
    want_fused = dict(want, fused_geglu_ffn=n_layer_calls)
    served_fused, fused_launches = serve(
        "fused-ffn", lambda i: fused_iface.vamp_e2e(sig, seed=SEED + i, **kw), OPTION_REQUESTS,
        counters, want_fused, n_samples)
    launches["fused_geglu_ffn"] = fused_launches["fused_geglu_ffn"]
    busy_fused, _ = profile("fused-ffn request", lambda: fused_iface.vamp_e2e(sig, seed=96, **kw),
                         totals=("rms_norm_kernel", "ffn_gemm_kernel", "nvjet"))
    print(f"profile: fused-ffn request busy {busy_fused:.1f} ms, bf16 request busy "
          f"{busy_bf16:.1f} ms (one request each, the same signal and settings)")
    for h in hooks:
        h.remove()
    if ffn_calls[0] or len(hooks) != 2 * (coarse_cfg.n_layers + c2f_cfg.n_layers):
        raise AssertionError(f"the fused path ran {ffn_calls[0]} w_1/w_2 products")
    del fused_iface

    # ---- 11. the int8 option: Interface.quantize() on the served weights ----
    t0 = time.perf_counter()
    iface.quantize()
    torch.cuda.synchronize()
    print(f"setup: quantized in {time.perf_counter() - t0:.1f} s")
    scales = [b for lm in (iface.coarse, iface.c2f) for n_, b in lm.named_buffers()
              if n_.endswith("w_scale")]
    if len(scales) != 6 * (coarse_cfg.n_layers + c2f_cfg.n_layers) or \
            any(s.dtype != torch.float32 for s in scales):
        raise AssertionError("quantize() left a projection unquantized or a scale not fp32")
    want_int8 = dict(want, w8a8_matmul=6 * n_layer_calls)
    served_int8, int8_launches = serve("int8", lambda i: iface.vamp_e2e(sig, seed=SEED + i, **kw),
                                       OPTION_REQUESTS, counters, want_int8, n_samples)
    launches["w8a8_matmul"] = int8_launches["w8a8_matmul"]
    busy_int8, _ = profile("int8 request", lambda: iface.vamp_e2e(sig, seed=98, **kw),
                        totals=("row_quant_kernel", "w8a8_wgmma_kernel", "nvjet"))
    print(f"profile: int8 request busy {busy_int8:.1f} ms, bf16 request busy {busy_bf16:.1f} ms "
          f"(one request each, the same signal and settings)")

    # ---- 12. the two options on the card against the CPU ----
    print("cpu check: " + json.dumps(check_options_against_cpu(gen)))

    # ---- 13. the published architecture (LoRA r=8) from checkpoint files ----
    files, lora_launches, lora_int8_launches = serve_from_files(
        iface.codec, sig, kw, counters, want, n_samples, busy_bf16, launches_bf16)

    # ---- 14. the trainer: the loop from the repo's configs, the codec's
    # compute options, the step's options ----
    trainer = trainer_phase(codec_cfg, sig, kw, n_samples, gen)

    # ---- 15. the entry points: convert_reference, vamp_microbatched, the
    # debug dumps, experiment and eval with VGGish, Interface.to, hello ----
    entry_points, entry_kernels = entry_points_phase(codec_cfg, sig, kw, counters, want,
                                                     n_samples, gen)
    micro_runs = entry_points["vamp_microbatched"]["runs"]

    def entry(name, source, replaces, res, main="coarse"):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], **{k: res[main][k] for k in keys},
            **{shape: {k: v for k, v in r.items()} for shape, r in res.items() if shape != main},
        )

    def engine_errs(name):
        return {k: v["max_abs_err"] for k, v in engine_phase["kernel_checks"].items()
                if k.startswith(name)}

    kernels = [
        dict(entry("attention_fwd", "vampnet_tpu_torch/csrc/attention_fwd.cu",
                   "vampnet_tpu/ops/flash_attention.py:120", attn), registers=fwd_regs,
             launches_lora=lora_launches["attention_fwd"],
             launches_per_engine_group=engine_group["attention_fwd"],
             max_abs_err_engine_shapes=engine_errs("attention_fwd"),
             max_abs_err_doubled_batch=option_k1["max_abs_err"],
             max_abs_err_trainer_shapes=trainer["max_abs_err_trainer_shapes"]["attention_fwd"],
             launches_trainer=trainer["launches"]["attention_fwd"],
             entry_points_shapes=entry_kernels["attention_fwd"],
             launches_vamp_microbatched={k: r["launches"]["attention_fwd"]
                                         for k, r in micro_runs.items()}),
        dict(entry("attention_fwd_masked", "vampnet_tpu_torch/csrc/attention_fwd.cu",
                   "vampnet_tpu/ops/flash_attention.py:93", results["attention_fwd_masked"]),
             also_replaces="without a mask at 896 < t <= 1024: attention_fwd (K1) at t948",
             launches_path="masked TransformerStack, inference forward"),
        dict(entry("attention_fwd_long", "vampnet_tpu_torch/csrc/attention_fwd.cu",
                   "vampnet_tpu/ops/flash_attention.py:47", results["attention_fwd_long"],
                   main=f"t{t_long}"),
             launches_path="staged requests with a 20 s coarse chunk"),
        dict(entry("sampler", "vampnet_tpu_torch/csrc/sampler.cu",
                   "vampnet_tpu/ops/sampler_kernel.py:80", samp), registers=sampler_regs,
             launches_lora=lora_launches["sampler"],
             launches_per_engine_group=engine_group["sampler"],
             max_abs_err_engine_shapes=engine_errs("sampler"), top_k=topk_k10,
             launches_trainer=trainer["launches"]["sampler"],
             max_abs_err_trainer_shapes=trainer["max_abs_err_trainer_shapes"]["sampler"],
             launches_per_option_request={k: v["launches_per_request"]["sampler"]
                                          for k, v in options["staged"].items()
                                          if isinstance(v, dict)},
             entry_points_shapes=entry_kernels["sampler"],
             launches_vamp_microbatched={k: r["launches"]["sampler"]
                                         for k, r in micro_runs.items()}),
    ]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, replaces, also in (
        ("attention_fwd_lse", ":254", "_attn_kernel_fwd_lse_dt :153 (same out and lse)"),
        ("attention_bwd_fused", ":428",
         "_attn_kernel_bwd_wholeseq's one pass; the split pair _attn_kernel_bwd_dkdv :336 and "
         "_attn_kernel_bwd_dq_dbias :381 (the same function)"),
    ):
        res = train_k[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"vampnet_tpu_torch/csrc/attention_{name.split('_')[1]}.cu",
            replaces=f"vampnet_tpu/ops/flash_attention.py{replaces}", also_replaces=also,
            launches=launches[name], **{k: res[k] for k in keys},
            shape=f"b={TRAIN_BATCH} t={t_coarse} h={coarse_cfg.n_heads} d={d_head}",
            library_note=res.get("library_note"),
            b16={k: v for k, v in train_k16[name].items()},
            b1_t2048={k: v for k, v in train_k2048[name].items()},
            launches_trainer=trainer["launches"][name],
            max_abs_err_trainer_shapes=trainer["max_abs_err_trainer_shapes"][name],
            **({"registers": bwd_regs} if name == "attention_bwd_fused" else {}),
        ))
    for name, replaces, also in (
        ("attention_fwd_lse_masked", ":254",
         "over the per-(b*h) bias that :913-921 folds the mask into (K3's scores)"),
        ("attention_bwd_fused_masked", ":279", "K5's dq, dk, dv and its dbias summed over the batch"),
    ):
        res = masked_k[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"vampnet_tpu_torch/csrc/attention_{name.split('_')[1]}.cu",
            replaces=f"vampnet_tpu/ops/flash_attention.py{replaces}", also_replaces=also,
            launches=launches[name], **{k: res[k] for k in keys},
            shape=f"b={TRAIN_BATCH} t={t_coarse} h={coarse_cfg.n_heads} d={d_head}, "
                  f"key padding {list(valid)}",
            library_note=res.get("library_note"), call_ms=res["call_ms"],
            launches_path="masked TransformerStack, forward and backward",
        ))
    kernels.append(dict(
        entry("w8a8_matmul", "vampnet_tpu_torch/csrc/int8_matmul.cu",
              "vampnet_tpu/ops/int8_matmul.py:36", results["w8a8_matmul"], main="coarse_w_1"),
        main_shape=f"coarse w_1: m={m_rows['coarse']} k={d_model} n={4 * d_model}",
        launches_per_request=6 * n_layer_calls, registers=w8a8_regs,
        launches_lora_int8=lora_int8_launches["w8a8_matmul"]))
    kernels.append(dict(
        entry("fused_geglu_ffn", "vampnet_tpu_torch/csrc/ffn.cu",
              "vampnet_tpu/ops/ffn_kernel.py:44", results["fused_geglu_ffn"]),
        main_shape=f"coarse: m={m_rows['coarse']} d={d_model}",
        launches_per_request=n_layer_calls, registers=ffn_regs))
    print("serve summary: " + json.dumps({"bf16": served, "fused_ffn": served_fused,
                                          "int8": served_int8, "long_20s": served_long,
                                          "chunk_11s": served_11}))
    print("engine summary: " + json.dumps(engine_phase))
    print("masked stack summary: " + json.dumps(masked_stack))
    print("train summary: " + json.dumps(train))
    print("options summary: " + json.dumps(options))
    print("trainer summary: " + json.dumps(trainer))
    print("entry points summary: " + json.dumps(entry_points))
    print(f"total wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
