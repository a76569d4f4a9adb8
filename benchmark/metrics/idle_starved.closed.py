"""The card's idle time while no group is being enqueued, in % of the
traced stretch: the idle time (outside the union of the card's activities)
during which no port `engine.dispatch` span was open (the dispatcher waits
for requests or for `pipeline_depth`). With `idle_dispatching.closed` it
adds up to `idle_share.closed`."""

from benchmark.harness import program_spans


def read(run):
    split = program_spans.idle_share_split(run)
    return split[1] if split else None
