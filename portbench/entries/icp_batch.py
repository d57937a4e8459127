"""``tpuslam_torch.match.icp.icp_batch``: every call registers a chunk of
the bag's pairs (scan i+1 onto scan i) by point-to-point ICP; the
``csrc/plicp_corr.cu`` kernel in nearest mode finds the neighbours."""

from __future__ import annotations

from tpuslam_torch.core.config import IcpConfig
from tpuslam_torch.match.icp import icp_batch
from tpuslam_torch.ops import plicp as ops

from portbench import check
from portbench.bag import pair_inputs
from portbench.reference.icp import icp

COUNTERS = ops.LAUNCHES
# a pair whose pose lies farther than this from the reference's is off
OFF_M = 0.01


def passes(params: dict) -> int:
    return params["max_iterations"]


def program(params: dict, bag):
    cfg = IcpConfig(**params)

    def call(a: int, b: int) -> dict:
        r = icp_batch(cfg, *pair_inputs(bag, a, b))
        return {"pose": r.pose, "converged": r.converged,
                "mean_error": r.mean_error}

    return call


def reference(params: dict, bag, a: int, b: int, dtype) -> dict:
    src, sv, ref, rv, init = pair_inputs(bag, a, b)
    return icp(params, src.to(dtype), sv, ref.to(dtype), rv, init.to(dtype))


def compare(out: dict, ref: dict) -> dict:
    """The count of pairs whose pose lies more than ``OFF_M`` from the
    reference's, which guards the answers one by one, and means over the
    call's pairs, which hold the call as a whole tightly.  ICP's widest
    gap swings from seed to seed (``portbench/check.py``) up to a third of
    the control's, so it is not compared."""
    xy, th = check.pose_gaps(out["pose"], ref["pose"],
                             out["converged"] == ref["converged"])
    return {"pose_xy_off_pairs": float((xy > OFF_M).sum()),
            "pose_xy_mean_gap_m": float(xy.mean()),
            "pose_theta_mean_gap_rad": float(th.mean()),
            "mean_error_mean_gap_m": float(check.gaps(out["mean_error"],
                                                      ref["mean_error"]).mean())}
