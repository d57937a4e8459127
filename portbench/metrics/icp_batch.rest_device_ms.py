"""Device milliseconds a call of ``icp_batch`` outside the
nearest-mode kernel: the transform, the rigid fit's sums and
every fill and copy."""

from portbench import roofline, trace


def read(run):
    return trace.rest_device_ms(run, "icp_batch", roofline.CORR_KERNEL)
