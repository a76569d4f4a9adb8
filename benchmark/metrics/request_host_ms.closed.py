"""The request thread's own time per web request, in ms: the median, over
the port's `webapp.request` spans that ended in the traced stretch, of the
span less its `webapp.engine_wait` (encode, mask, decode and loudness in
the caller's thread, with their waits for the card and the interpreter)."""

import statistics

from benchmark.harness import program_spans


def read(run):
    waits = {r.ids.get("request"): program_spans.ms(r)
             for r in program_spans.records("webapp.engine_wait")}
    own = [program_spans.ms(r) - waits[r.id]
           for r in program_spans.ended_in(run, "webapp.request") if r.id in waits]
    return statistics.median(own) if own else None
