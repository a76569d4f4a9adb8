"""The codec's share of the card's busy time in the traced window, in %:
the device time of the kernels launched inside the benchmark's codec spans
(the Interface's encode and decode, which `vamp_core_engine` runs in the
request's thread) over the union of all activity."""


def read(run):
    ns, n = run.trace.kernel_time(lambda name, span: span is not None
                                  and span.startswith("codec."))
    return 100.0 * ns / run.trace.busy_ns if n else None
