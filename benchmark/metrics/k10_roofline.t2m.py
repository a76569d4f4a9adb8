"""K10, the sampler kernel, at V = 2,048 with top-p, as a share of its
roofline, in %: the mean least time of a launch over the LM forwards of
the traced window (one launch per forward, over the group's conditioned
rows, the frames and the vocabulary, fp32; `roofline_magnet.k10_top_p`)
over the mean measured time of the window's sampler launches."""

from benchmark import roofline_magnet as rm

KERNEL = "sampler_kernel"


def read(run):
    card = run.config["lm"]["card"]
    least = [rm.least_s(*rm.k10_top_p(rows // 2, t, card), rm.H100_FP32_FLOPS)
             for _stage, rows, t, _text in run.sut.forwards_between(*run.trace.window_ns)]
    ns, k = run.trace.kernel_time(lambda name, span: KERNEL in name)
    if not least or not k:
        return None
    return 100.0 * (sum(least) / len(least)) / (ns / 1e9 / k)
