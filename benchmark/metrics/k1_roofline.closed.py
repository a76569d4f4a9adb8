"""K1, the inference attention kernel (`attention_fwd_kernel` in the LMs'
forwards), as a share of its roofline, in %: the mean least time of a
launch over the window's LM forwards (one launch per layer at the forward's
rows and tokens, 20 heads of 64 and a bf16 bias) over the mean measured
time of the window's K1 launches."""

KERNEL = "attention_fwd_kernel"


def read(run):
    rf, cfg = run.roofline, run.config
    least, n = 0.0, 0
    for lm, b, t in run.sut.forwards_between(*run.trace.window_ns):
        c = cfg[lm]
        h, d = c["n_heads"], c["embedding_dim"] // c["n_heads"]
        least += c["n_layers"] * rf.least_s(*rf.k1_attention_fwd(b, t, h, d))
        n += c["n_layers"]
    ns, k = run.trace.kernel_time(lambda name, span: KERNEL in name)
    if not n or not k:
        return None
    return 100.0 * (least / n) / (ns / 1e9 / k)
