"""Device operations (kernels, fills and copies) the host issued a call:
those in the traced window over the calls traced."""


def read(run):
    t = run.trace
    if t is None or not t.count():
        return None
    return t.count() / t.calls
