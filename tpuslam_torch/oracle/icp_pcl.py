"""float64 oracle of PCL's default ``IterativeClosestPoint``, as lesson2 uses it.

The reference node (lesson2/src/scan_match_icp.cc:135-164) calls
``pcl::IterativeClosestPoint<PointXYZ, PointXYZ>`` with ALL defaults:
source = previous cloud, target = current cloud, ``icp_.align()``.  PCL is
not vendored in the reference tree; this oracle restates the library's
default registration pipeline (pcl/registration/icp.hpp +
default_convergence_criteria.h + transformation_estimation_svd.hpp) in
NumPy float64, restricted to z = 0 clouds (the node's are):

- ``ConvertScan2PointCloud`` (scan_match_icp.cc:90-130) resizes the cloud
  to nrays and takes a REFERENCE to points[i]; beams that are non-finite
  or outside (range_min, range_max) leave the element default-constructed
  — i.e. a stray point at the ORIGIN (0,0,0) that participates in
  matching.  ``convert_scan_to_cloud`` reproduces that quirk.
- per iteration: exact nearest-neighbor correspondences from the
  so-far-transformed source to the target (PCL's kd-tree is exact; the
  default ``corr_dist_threshold_`` is sqrt(DBL_MAX), i.e. no gate, and no
  correspondence rejectors are installed by default); fewer than
  ``min_number_correspondences_ = 3`` aborts with converged = False.
- ``TransformationEstimationSVD``: demean both sides over the
  correspondence set, H = src_demean^T tgt_demean, SVD, R = V U^T with a
  last-column flip when det < 0, t = centroid_tgt - R centroid_src —
  applied INCREMENTALLY (``final = incremental * final``; the next
  iteration matches the already-transformed source).
- ``DefaultConvergenceCriteria`` with its constructor defaults
  (max_iterations from Registration = 10, rotation_threshold = 0.99999
  on cos(angle) of the INCREMENTAL rotation, translation_threshold =
  (3e-4)^2 on its squared translation — both must hold together,
  max_iterations_similar_transforms = 0, mse_absolute = 1e-12,
  mse_relative = 1e-5 vs the previous iteration's mean squared
  correspondence distance).  Reaching max_iterations counts as CONVERGED
  (failure_after_max_iter_ defaults to false) — so the node's
  "not Converged" branch only fires on correspondence starvation.

Used only by tests/test_oracle_parity.py to differential-test
match/icp.py (the MXU-matmul NN + closed-form 2D Umeyama formulation).
"""

from __future__ import annotations

import math

import numpy as np


def convert_scan_to_cloud(ranges, angle_min, angle_increment, range_min,
                          range_max):
    """scan_match_icp.cc:90-130 incl. the stray-origin-point quirk."""
    ranges = np.asarray(ranges, np.float64)
    n = ranges.shape[0]
    cloud = np.zeros((n, 2), np.float64)  # default-constructed PointXYZ
    for i in range(n):
        r = ranges[i]
        if not np.isfinite(r):
            continue
        if range_min < r < range_max:
            angle = angle_min + i * angle_increment
            cloud[i, 0] = r * math.cos(angle)
            cloud[i, 1] = r * math.sin(angle)
    return cloud


class OraclePclIcpResult:
    def __init__(self, converged, transform, iterations, state):
        self.converged = converged
        self.transform = transform  # [3,3] homogeneous 2D
        self.iterations = iterations
        self.state = state  # convergence-state label, for test introspection

    @property
    def x(self):
        """(x, y, yaw) like pcl::getTranslationAndEulerAngles on z=0."""
        return np.array([
            self.transform[0, 2],
            self.transform[1, 2],
            math.atan2(self.transform[1, 0], self.transform[0, 0]),
        ])


class OraclePclIcp:
    """Default-parameter pcl::IterativeClosestPoint on 2D clouds."""

    def __init__(self, max_iterations=10):
        self.max_iterations = max_iterations
        self.rotation_threshold = 0.99999
        self.translation_threshold = 3e-4 * 3e-4
        self.mse_threshold_absolute = 1e-12
        self.mse_threshold_relative = 1e-5
        self.min_number_correspondences = 3

    def align(self, source, target) -> OraclePclIcpResult:
        src = np.asarray(source, np.float64)
        tgt = np.asarray(target, np.float64)
        cur = src.copy()
        final = np.eye(3)
        prev_mse = math.inf
        iterations = 0
        if tgt.shape[0] == 0:
            return OraclePclIcpResult(False, final, 0, "NO_CORRESPONDENCES")
        while True:
            # exact NN (kd-tree contract); distance = squared, first-best
            d2 = ((cur[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
            nn = np.argmin(d2, axis=1)
            nn_d2 = d2[np.arange(cur.shape[0]), nn]
            if cur.shape[0] < self.min_number_correspondences:
                return OraclePclIcpResult(False, final, iterations,
                                          "NO_CORRESPONDENCES")
            matched = tgt[nn]

            # TransformationEstimationSVD over ALL correspondences
            c_src = cur.mean(axis=0)
            c_tgt = matched.mean(axis=0)
            H = (cur - c_src).T @ (matched - c_tgt)
            U, _, Vt = np.linalg.svd(H)
            V = Vt.T
            R = V @ U.T
            if np.linalg.det(R) < 0:
                V2 = V.copy()
                V2[:, -1] *= -1
                R = V2 @ U.T
            t = c_tgt - R @ c_src
            inc = np.eye(3)
            inc[:2, :2] = R
            inc[:2, 2] = t

            cur = cur @ R.T + t
            final = inc @ final
            iterations += 1

            # DefaultConvergenceCriteria::hasConverged, defaults
            if iterations >= self.max_iterations:
                return OraclePclIcpResult(True, final, iterations,
                                          "ITERATIONS")
            # 3D trace formula on the embedded 2D rotation: the z-z entry
            # of the embedding is 1, so cos_angle = 0.5*(r00 + r11 + 1 - 1)
            cos_angle = 0.5 * (R[0, 0] + R[1, 1])
            translation_sqr = float(t @ t)
            if (cos_angle >= self.rotation_threshold
                    and translation_sqr <= self.translation_threshold):
                return OraclePclIcpResult(True, final, iterations,
                                          "TRANSFORM")
            cur_mse = float(nn_d2.mean())
            if abs(cur_mse - prev_mse) < self.mse_threshold_absolute:
                return OraclePclIcpResult(True, final, iterations,
                                          "ABS_MSE")
            if prev_mse != 0 and math.isfinite(prev_mse) and (
                    abs(cur_mse - prev_mse) / prev_mse
                    < self.mse_threshold_relative):
                return OraclePclIcpResult(True, final, iterations,
                                          "REL_MSE")
            prev_mse = cur_mse
