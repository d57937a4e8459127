"""``csrc/hector_gn.cu``, the finest level of Hector's pyramid: its share
of its roofline, in per cent (``roofline_hector.gn_share``): the least time
of one call's work (every beam, ``iterations_finest`` iterations, the grid
read once) times the calls traced, over the kernel's profiled time."""

from portbench import roofline_hector


def read(run):
    return roofline_hector.gn_share(run)
