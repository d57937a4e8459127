"""Device milliseconds a call of ``icp_batch`` in its rigid fits (the span
``icp.fit``, read from the program): the weights, ``rigid_fit_2d``'s
centroids and sums and the compose, every pass."""

from portbench import spans


def read(run):
    return spans.per_call_ms(run, "icp.fit", device=True)
