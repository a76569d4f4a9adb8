"""The codec's share of the card's busy time in the traced window, in %:
the device time of the kernels of the benchmark's `codec.decode` spans (the
EnCodec decode of each engine group) over the union of all activity."""

from benchmark import roofline_magnet as rm


def read(run):
    ns = sum(e - s for _n, s, e, span in rm.stream_spans(run.trace) if span == "codec.decode")
    return 100.0 * ns / run.trace.busy_ns if ns else None
