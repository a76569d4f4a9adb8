"""The card's idle time while the dispatcher enqueues a group, in % of the
traced stretch: the part of the idle time (outside the union of the card's
activities) during which a port `engine.dispatch` span was open. With
`idle_starved.closed` it adds up to `idle_share.closed`."""

from benchmark.harness import program_spans


def read(run):
    split = program_spans.idle_share_split(run)
    return split[0] if split else None
