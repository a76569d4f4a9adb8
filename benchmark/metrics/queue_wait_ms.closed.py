"""The median wait of an engine request in `VampEngine`'s queue, in ms: the
port's `engine.queue` spans (from `submit` to the start of the group the
dispatcher took it into) that ended in the traced stretch."""

import statistics

from benchmark.harness import program_spans


def read(run):
    waits = [program_spans.ms(r) for r in program_spans.ended_in(run, "engine.queue")]
    return statistics.median(waits) if waits else None
