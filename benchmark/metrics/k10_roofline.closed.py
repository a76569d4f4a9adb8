"""K10, the sampler kernel (`sampler_kernel`), as a share of its roofline,
in %: the mean least time of a launch over the window's MaskGIT steps (one
launch per LM forward, over its rows, tokens x predicted codebooks and the
vocabulary, fp32) over the mean measured time of the window's K10 launches."""

KERNEL = "sampler_kernel"


def read(run):
    rf, cfg = run.roofline, run.config
    least, n = 0.0, 0
    for lm, b, t in run.sut.forwards_between(*run.trace.window_ns):
        c = cfg[lm]
        flat = t * (c["n_codebooks"] - c["n_conditioning_codebooks"])
        least += rf.least_s(*rf.k10_sampler(b, flat, c["vocab_size"]), rf.H100_FP32_FLOPS)
        n += 1
    ns, k = run.trace.kernel_time(lambda name, span: KERNEL in name)
    if not n or not k:
        return None
    return 100.0 * (least / n) / (ns / 1e9 / k)
