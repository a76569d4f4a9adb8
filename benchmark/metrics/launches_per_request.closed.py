"""Device kernels started in the traced part of the window per request
served in it (a request in flight at its edges counts by its share inside)."""


def read(run):
    done = sum(share for _d, share in run.sut.credited(*run.sut.trace_window))
    return len(run.trace.kernels) / done if done else None
