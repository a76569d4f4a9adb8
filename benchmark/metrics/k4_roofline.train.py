"""K4, the training attention forward (`attention_fwd_kernel` writing lse
rows), as a share of its roofline, in %: its least time at the step's batch
rows, tokens, heads and fp32 bias over the mean measured launch."""

KERNEL = "attention_fwd_kernel"


def read(run):
    rf, c = run.roofline, run.config["lm"]
    b, t = run.sut.batch_shape()
    h, d = c["n_heads"], c["embedding_dim"] // c["n_heads"]
    ns, k = run.trace.kernel_time(lambda name, span: KERNEL in name)
    if not k:
        return None
    return 100.0 * rf.least_s(*rf.k4_attention_fwd_lse(b, t, h, d)) / (ns / 1e9 / k)
