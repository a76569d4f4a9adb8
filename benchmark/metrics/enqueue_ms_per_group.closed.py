"""The host's enqueue of an engine group, in ms: the mean of the port's
`engine.dispatch` spans (the dispatcher's eager calls of a group's coarse
and c2f MaskGIT loops, which queue their kernels and return) that ended in
the traced stretch."""

import statistics

from benchmark.harness import program_spans


def read(run):
    groups = [program_spans.ms(r) for r in program_spans.ended_in(run, "engine.dispatch")]
    return statistics.fmean(groups) if groups else None
