"""Stage 0's share of the LM's device time in the traced window, in %: the
device time of the kernels of stage-0 forwards and the sampling after them
(the benchmark's `lm.s0` spans, with the kernels that follow each on the
stream; `roofline_magnet.stream_spans`) over that of every stage's (`lm.s*`).
Stage 0 runs 60 of a request's 90 steps with full attention; stages 1-3 run
banded."""

from benchmark import roofline_magnet as rm


def read(run):
    stage = {}
    for _n, s, e, span in rm.stream_spans(run.trace):
        if span is not None and span.startswith("lm.s"):
            stage[span] = stage.get(span, 0) + e - s
    total = sum(stage.values())
    return 100.0 * stage.get("lm.s0", 0) / total if total else None
