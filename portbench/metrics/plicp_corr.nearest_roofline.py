"""The nearest mode of ``csrc/plicp_corr.cu``: its share of its roofline, in
per cent (``roofline.corr_share``).  The count is of the exhaustive search
the kernel does today: a kernel that prunes it makes the share read high,
and only a benchmark change may recount it."""

from portbench import roofline


def read(run):
    return roofline.corr_share(run, ("plicp_nearest", "plicp_nearest_wide"))
