"""Device milliseconds a call of ``plicp_batch`` outside the
correspondence kernel: the transform, the trim's sort, the Gauss-Newton
system and its solve, and every fill and copy."""

from portbench import roofline, trace


def read(run):
    return trace.rest_device_ms(run, "plicp_batch", roofline.CORR_KERNEL)
