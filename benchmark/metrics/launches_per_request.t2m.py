"""Device kernels started in the traced part of the text-to-music window per
request served in it (a request in flight at its edges counts by its share
inside): the LM's per-step launches, T5's and the decoder's."""


def read(run):
    done = sum(share for _d, share in run.sut.credited(*run.sut.trace_window))
    return len(run.trace.kernels) / done if done else None
