"""``csrc/hector_gn.cu``, every level of Hector's pyramid that it runs: its
share of its roofline, in per cent (``roofline_hector.gn_share``): the
least time of a call's launches (each at its level's grid and iterations,
every beam) times the calls traced, over the kernel's profiled time."""

from portbench import roofline_hector


def read(run):
    return roofline_hector.gn_share(run)
