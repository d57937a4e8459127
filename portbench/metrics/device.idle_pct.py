"""The device's idle share of the traced window, in per cent: 100 times
one less the union of the device operations' time over the window."""


def read(run):
    t = run.trace
    if t is None or not t.count():
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
