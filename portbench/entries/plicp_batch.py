"""``tpuslam_torch.match.plicp.plicp_batch``: every call registers a chunk
of the bag's pairs (scan i+1 onto scan i) by PL-ICP; the
``csrc/plicp_corr.cu`` kernel in line mode finds the correspondences."""

from __future__ import annotations

from tpuslam_torch.core.config import PlicpConfig
from tpuslam_torch.match.plicp import plicp_batch
from tpuslam_torch.ops import plicp as ops

from portbench import check
from portbench.bag import pair_inputs
from portbench.reference.plicp import plicp

COUNTERS = ops.LAUNCHES


def passes(params: dict) -> int:
    return params["max_iterations"]


def program(params: dict, bag):
    cfg = PlicpConfig(**params)

    def call(a: int, b: int) -> dict:
        r = plicp_batch(cfg, *pair_inputs(bag, a, b))
        return {"pose": r.pose, "valid": r.valid, "mean_error": r.mean_error,
                "num_inliers": r.num_inliers}

    return call


def reference(params: dict, bag, a: int, b: int, dtype) -> dict:
    src, sv, ref, rv, init = pair_inputs(bag, a, b)
    return plicp(params, src.to(dtype), sv, ref.to(dtype), rv, init.to(dtype))


def compare(out: dict, ref: dict) -> dict:
    xy, th = check.pose_gaps(out["pose"], ref["pose"],
                             out["valid"] == ref["valid"])
    return {"pose_xy_gap_m": float(xy.max()),
            "pose_xy_mean_gap_m": float(xy.mean()),
            "pose_theta_gap_rad": float(th.max()),
            "mean_error_gap_m": float(check.gaps(out["mean_error"],
                                                 ref["mean_error"]).max()),
            "inliers_gap": float(check.gaps(out["num_inliers"],
                                            ref["num_inliers"]).max())}
