"""Scans registered a second: the pairs matched in all the window's calls
over all the window's seconds (host clock, from the first call's start to
the synchronize, after the last call was issued, that waits for every
call to end)."""


def read(run):
    return run.calls * run.pairs_per_call / run.window_s
