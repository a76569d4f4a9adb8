"""The LM's attention kernel (the no-bias instances of the attention
forward, K9 at 1,500 frames), as a share of its roofline, in %: per LM
forward of the traced window, each layer's self-attention (every key at
stage 0, the |i - j| <= 5 band at stages 1-3) and cross-attention over the
group's text (`roofline_magnet.attention_fwd`), the mean least time of a
launch, over the mean measured time of the window's attention launches in
the LM's spans (T5's masked launches are outside them)."""

from benchmark import roofline_magnet as rm

KERNEL = "attention_fwd_kernel"


def read(run):
    lm = run.config["lm"]
    h, d = lm["n_heads"], lm["dim"] // lm["n_heads"]
    least, n = 0.0, 0
    for stage, rows, t, text in run.sut.forwards_between(*run.trace.window_ns):
        kq = None if stage == 0 else rm.band_keys(t, lm["subcodes_context"])
        per_layer = (rm.least_s(*rm.attention_fwd(rows, t, t, h, d, kq))
                     + rm.least_s(*rm.attention_fwd(rows, t, text, h, d)))
        least += lm["n_layers"] * per_layer
        n += 2 * lm["n_layers"]
    ns = k = 0
    for name, s, e, span in rm.stream_spans(run.trace):
        if KERNEL in name and span is not None and span.startswith("lm.s"):
            ns += e - s
            k += 1
    if not n or not k:
        return None
    return 100.0 * (least / n) / (ns / 1e9 / k)
