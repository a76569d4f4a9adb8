"""The card's idle share of the text-to-music cell's traced window: 1 - (the
union of its activities' intervals) / the window, in %."""


def read(run):
    return 100.0 * run.trace.idle_share()
