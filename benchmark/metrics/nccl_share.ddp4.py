"""NCCL's share of rank 0's busy card time in the traced window, in %: the
device time of NCCL's kernels (the gradients' all-reduce over dp, ZeRO-1's
gather of the updated slices, the metrics' sums and rank 0's step flag),
which includes their waits for the other cards, over the union of all
activity."""


def read(run):
    ns, n = run.trace.kernel_time(lambda name, span: "nccl" in name.lower())
    return 100.0 * ns / run.trace.busy_ns if n else None
