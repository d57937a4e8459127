"""The numbers that decide ``correct``: gaps between what the program
returned and what the plain reference computes from the same inputs.

Each function gives a gap a pair, in float64; an entry reduces them over
the pairs of a call: to the widest, to the mean, or to the count of pairs
past a distance.  A pair whose answer is not finite, or whose flag
(PL-ICP's ``valid``, ICP's ``converged``) differs from the reference's,
reads an infinite pose gap.  The widest gap, or the count, guards each
answer.  The mean guards the call as a whole, and stays steady where a
matcher amplifies a near-tie: in the port's point-to-point ICP the
centroids' rounding flips a neighbour now and then, and ICP's flat valleys
grow that to millimetres by the last iteration, so its widest gap swings
from seed to seed.
"""

from __future__ import annotations

import math

import torch


def pose_gaps(pose, ref_pose, flags_agree):
    """(xy distance in metres, heading difference in radians) a pair
    between two [P, 3] pose sets."""
    d = pose.double() - ref_pose.double()
    xy = torch.hypot(d[:, 0], d[:, 1])
    th = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2])).abs()
    bad = ~flags_agree | ~torch.isfinite(pose).all(-1)
    return torch.where(bad, math.inf, xy), torch.where(bad, math.inf, th)


def gaps(values, ref_values):
    """The absolute difference a pair between two [P] arrays."""
    d = (values.double() - ref_values.double()).abs()
    return torch.where(torch.isfinite(d), d, math.inf)
