"""float64 oracle of CSM's ``sm_icp`` (Censi's PL-ICP), as lesson3 uses it.

The reference node shells out to the external CSM C library
(lesson3/src/plicp_odometry.cc:391 ``sm_icp(&input_, &output_)``; the ~30
knob defaults at plicp_odometry.cc:58-186).  CSM itself is NOT vendored in
the reference tree (lesson3/CMakeLists.txt links the system ``csm``
package), so this oracle restates the library's numerical contract —
``icp.c`` / ``icp_loop.c`` / ``icp_corr_dumb.c`` / ``icp_outliers.c`` /
``gpc/gpc.c`` of AndreaCensi/csm — in scalar NumPy float64:

- ``ld_invalid_if_outside``: a reading is killed when
  ``r <= min_reading or r > max_reading`` (on top of the node's own
  LaserScanToLDP gate ``range_min < r < range_max``,
  plicp_odometry.cc:286-303).
- ``find_correspondences`` (icp_corr_dumb.c): for each valid sensor point
  roto-translated by the current estimate, the nearest valid reference
  point ``j1`` within ``max_correspondence_dist`` is searched inside
  ``possible_interval`` (the angular window implied by
  max_angular_correction_deg + atan(max_linear_correction/|p|)); matches
  at the scan extrema (j1 == 0 or nrays-1) are dropped; the line's second
  point ``j2`` is the nearer of the next valid rays up/down (no distance
  gate).  ``use_corr_tricks=1`` routes CSM to the jump-table variant that
  ``debug_verify_tricks`` asserts gives the same answer; this oracle
  implements the dumb contract (the semantic ground truth).
- ``kill_outliers_double`` (icp_outliers.c): a correspondence dies when
  its squared distance exceeds ``3^2 x`` the best squared distance
  claiming the same reference point.
- ``kill_outliers_trim`` (icp_outliers.c): per-correspondence distance to
  the [j1, j2] SEGMENT (``dist_to_segment_d`` — clamped to the endpoints,
  unlike the solve which uses the infinite line); the kill threshold is
  ``min(sorted[floor(k*outliers_maxPerc)],
  outliers_adaptive_mult * sorted[floor(k*outliers_adaptive_order)])``
  with both order stats clamped to [0, k-1]; strictly-greater kills.
  ``total_error`` is the sum of surviving distances (i.e. the error of
  the PRE-update pose, which is what icp_loop reports).
- bail-outs: before trimming and again after, fewer than
  ``0.05 * nrays`` correspondences abort the loop with ``valid=0``
  (icp_loop.c fail_perc).
- ``compute_next_estimate`` + ``gpc_solve`` (gpc/gpc.c): the exact
  closed-form minimizer of sum (M_k x - q_k)' C_k (M_k x - q_k) over
  x = [tx, ty, cos t, sin t] subject to x[2:4] on the unit circle, with
  C_k = n n' the point-to-line projector from the [j1, j2] normal
  (point-to-point C_k = I when use_point_to_line_distance=0).  The
  Lagrangian condition (d_bigM + lambda W) x = d_g reduces by Schur
  complement to the quartic
  (l^2 + tr(S) l + det(S))^2 = w'w l^2 + 2 w' adj(S) w l + w' adj(S)^2 w,
  S = D - B' A^-1 B, w = g2 - B' A^-1 g1; CSM takes the GREATEST real
  root (poly_greatest_real_root) and recovers
  theta = atan2(x[3], x[2]).
- loop control (icp_loop.c): ``pose_diff_d`` (ominus(x_old) (+) x_new)
  feeds the termination test ``|delta_xy| < epsilon_xy and
  |delta_theta| < epsilon_theta``; with point-to-line the correspondence
  set is compared against every previous iteration's set (CSM hashes it
  with ``ld_corr_hash``; the oracle compares the sets exactly, a
  collision-free restatement) and a repeat terminates; ``iterations`` is
  1 + the index of the last executed iteration.
- restart (icp.c): when ``restart=1`` and ``error/nvalid >
  restart_threshold_mean_error``, six perturbed reruns
  (+-restart_dt on x, +-restart_dt on y, +-restart_dtheta) keep the
  lowest-error solution; iterations accumulate.

Knobs the node leaves at 0 and the oracle does not model:
``do_alpha_test``, ``do_visibility_test``, ``use_ml_weights``,
``use_sigma_weights`` (raise if set).  Used only by
tests/test_oracle_parity.py to differential-test match/plicp.py; the
production matcher is an independent TPU-first formulation (dense [B,B']
correspondence, quantile trim on the line distance, iterative GN) whose
optimum coincides with gpc's at convergence — the parity tests pin that
coincidence with stated tolerances instead of assuming it.
"""

from __future__ import annotations

import math

import numpy as np


class OracleLdp:
    """CSM laser_data: the fields sm_icp touches (laser_data.h)."""

    def __init__(self, readings, thetas, valid=None):
        self.readings = np.asarray(readings, np.float64).copy()
        self.theta = np.asarray(thetas, np.float64).copy()
        n = self.readings.shape[0]
        if valid is None:
            valid = np.ones(n, bool)
        self.valid = np.asarray(valid, bool).copy()
        self.nrays = n
        self.min_theta = float(self.theta[0])
        self.max_theta = float(self.theta[-1])
        self.points = np.zeros((n, 2), np.float64)
        self.points_w = np.zeros((n, 2), np.float64)
        # corr[i] = (valid, j1, j2, dist2_j1)
        self.corr_valid = np.zeros(n, bool)
        self.corr_j1 = np.full(n, -1, np.int64)
        self.corr_j2 = np.full(n, -1, np.int64)
        self.corr_dist2 = np.zeros(n, np.float64)

    @classmethod
    def from_scan(cls, ranges, angle_min, angle_increment, range_min,
                  range_max):
        """LaserScanToLDP (plicp_odometry.cc:286-323): valid iff
        range_min < r < range_max; invalid readings stored as -1."""
        ranges = np.asarray(ranges, np.float64)
        n = ranges.shape[0]
        thetas = angle_min + np.arange(n) * angle_increment
        ok = np.isfinite(ranges) & (ranges > range_min) & (ranges < range_max)
        readings = np.where(ok, ranges, -1.0)
        return cls(readings, thetas, ok)

    def invalid_if_outside(self, min_reading, max_reading):
        # ld_invalid_if_outside (laser_data.c)
        for i in range(self.nrays):
            if not self.valid[i]:
                continue
            r = self.readings[i]
            if r <= min_reading or r > max_reading:
                self.valid[i] = False

    def compute_cartesian(self):
        # ld_compute_cartesian: all rays, valid or not
        self.points[:, 0] = np.cos(self.theta) * self.readings
        self.points[:, 1] = np.sin(self.theta) * self.readings

    def compute_world_coords(self, pose):
        # ld_compute_world_coords: valid rays only
        c, s = math.cos(pose[2]), math.sin(pose[2])
        for i in range(self.nrays):
            if not self.valid[i]:
                continue
            x0, y0 = self.points[i]
            self.points_w[i, 0] = c * x0 - s * y0 + pose[0]
            self.points_w[i, 1] = s * x0 + c * y0 + pose[1]

    def set_null_correspondence(self, i):
        self.corr_valid[i] = False
        self.corr_j1[i] = -1
        self.corr_j2[i] = -1
        self.corr_dist2[i] = 0.0

    def num_valid_correspondences(self):
        return int(np.sum(self.corr_valid))

    def corr_set(self):
        """Exact restatement of ld_corr_hash equality (collision-free)."""
        return tuple(
            (i, int(self.corr_j1[i]), int(self.corr_j2[i]))
            for i in range(self.nrays)
            if self.corr_valid[i]
        )

    def next_valid(self, i, direction):
        j = i + direction
        while 0 <= j < self.nrays and not self.valid[j]:
            j += direction
        return j if 0 <= j < self.nrays and self.valid[j] else -1


def _oplus(x1, x2):
    c, s = math.cos(x1[2]), math.sin(x1[2])
    return np.array([
        x1[0] + c * x2[0] - s * x2[1],
        x1[1] + s * x2[0] + c * x2[1],
        x1[2] + x2[2],
    ])


def _ominus(x):
    c, s = math.cos(x[2]), math.sin(x[2])
    return np.array([
        -(c * x[0] + s * x[1]),
        -(-s * x[0] + c * x[1]),
        -x[2],
    ])


def _pose_diff(pose2, pose1):
    # pose_diff_d(pose2, pose1) = ominus(pose1) (+) pose2, angle wrapped
    res = _oplus(_ominus(pose1), pose2)
    while res[2] > math.pi:
        res[2] -= 2 * math.pi
    while res[2] < -math.pi:
        res[2] += 2 * math.pi
    return res


def _dist_to_segment(a, b, x):
    # dist_to_segment_d (math_utils.c): distance to the CLAMPED segment
    ab = b - a
    denom = float(ab @ ab)
    if denom == 0.0:
        return float(np.hypot(*(x - a)))
    t = float((x - a) @ ab) / denom
    proj = a + t * ab
    # CSM's inside test: (proj-a).(proj-b) < 0
    if float((proj - a) @ (proj - b)) < 0.0:
        return float(np.hypot(*(x - proj)))
    return float(min(np.hypot(*(x - a)), np.hypot(*(x - b))))


class OracleCsmResult:
    def __init__(self):
        self.valid = False
        self.x = np.zeros(3)
        self.error = 0.0
        self.nvalid = 0
        self.iterations = 0


class OracleCsm:
    """sm_icp with the lesson3 knob set.  ``params`` is a dict using CSM's
    own names; missing keys take plicp_odometry.cc's defaults."""

    DEFAULTS = dict(
        max_angular_correction_deg=45.0,
        max_linear_correction=1.0,
        max_iterations=10,
        epsilon_xy=1e-6,
        epsilon_theta=1e-6,
        max_correspondence_dist=1.0,
        sigma=0.010,
        restart=0,
        restart_threshold_mean_error=0.01,
        restart_dt=1.0,
        restart_dtheta=0.1,
        clustering_threshold=0.25,
        orientation_neighbourhood=20,
        use_point_to_line_distance=1,
        do_alpha_test=0,
        outliers_maxPerc=0.90,
        outliers_adaptive_order=0.7,
        outliers_adaptive_mult=2.0,
        do_visibility_test=0,
        outliers_remove_doubles=1,
        min_reading=0.0,
        max_reading=math.inf,
    )

    def __init__(self, **params):
        unknown = set(params) - set(self.DEFAULTS)
        if unknown:
            raise ValueError(f"unknown CSM params: {sorted(unknown)}")
        self.p = dict(self.DEFAULTS)
        self.p.update(params)
        if self.p["do_alpha_test"] or self.p["do_visibility_test"]:
            raise NotImplementedError(
                "oracle models the lesson3 node's knob set "
                "(do_alpha_test=0, do_visibility_test=0)"
            )

    # ------------------------------------------------------------------
    def sm_icp(self, laser_ref: OracleLdp, laser_sens: OracleLdp,
               first_guess) -> OracleCsmResult:
        p = self.p
        res = OracleCsmResult()

        laser_ref.invalid_if_outside(p["min_reading"], p["max_reading"])
        laser_sens.invalid_if_outside(p["min_reading"], p["max_reading"])
        laser_ref.compute_cartesian()
        laser_sens.compute_cartesian()

        x_old = np.asarray(first_guess, np.float64).copy()
        ok, x_new, error, nvalid, iterations = self._icp_loop(
            laser_ref, laser_sens, x_old
        )
        if not ok:
            res.valid = False
            res.iterations = iterations
            res.nvalid = 0
            return res

        best_error = error
        best_x = x_new.copy()
        if p["restart"] and nvalid > 0 and (
            error / nvalid > p["restart_threshold_mean_error"]
        ):
            dt, dth = p["restart_dt"], p["restart_dtheta"]
            perturb = [(dt, 0, 0), (-dt, 0, 0), (0, dt, 0), (0, -dt, 0),
                       (0, 0, dth), (0, 0, -dth)]
            for d in perturb:
                start = x_new + np.asarray(d, np.float64)
                ok_a, x_a, err_a, _, it_a = self._icp_loop(
                    laser_ref, laser_sens, start
                )
                if not ok_a:
                    break
                iterations += it_a
                if err_a < best_error:
                    best_x = x_a.copy()
                    best_error = err_a

        res.valid = True
        res.x = best_x
        res.error = best_error
        res.iterations = iterations
        res.nvalid = nvalid
        return res

    # ------------------------------------------------------------------
    def _icp_loop(self, laser_ref, laser_sens, q0):
        p = self.p
        if np.any(np.isnan(q0)):
            return False, q0.copy(), 0.0, 0, 0
        x_old = np.asarray(q0, np.float64).copy()
        x_new = x_old.copy()
        total_error = 0.0
        nvalid = 0
        seen_sets = []
        all_is_okay = True
        iteration = 0
        fail_perc = 0.05
        for iteration in range(int(p["max_iterations"])):
            laser_sens.compute_world_coords(x_old)
            self._find_correspondences(laser_ref, laser_sens)

            num_corr = laser_sens.num_valid_correspondences()
            if num_corr < fail_perc * laser_sens.nrays:
                all_is_okay = False
                break

            if p["outliers_remove_doubles"]:
                self._kill_outliers_double(laser_ref, laser_sens)

            total_error = self._kill_outliers_trim(laser_ref, laser_sens)
            num_corr_after = laser_sens.num_valid_correspondences()
            nvalid = num_corr_after

            if num_corr_after < fail_perc * laser_sens.nrays:
                all_is_okay = False
                break

            ok, x_new = self._compute_next_estimate(
                laser_ref, laser_sens, x_old
            )
            if not ok:
                all_is_okay = False
                break

            delta = _pose_diff(x_new, x_old)

            if p["use_point_to_line_distance"]:
                sig = laser_sens.corr_set()
                if sig in seen_sets:
                    break
                seen_sets.append(sig)

            if (math.hypot(delta[0], delta[1]) < p["epsilon_xy"]
                    and abs(delta[2]) < p["epsilon_theta"]):
                break

            x_old = x_new.copy()
        return all_is_okay, x_new, total_error, nvalid, iteration + 1

    # ------------------------------------------------------------------
    def _possible_interval(self, p_i_w, ld):
        p = self.p
        angle_res = (ld.max_theta - ld.min_theta) / ld.nrays
        delta = abs(math.radians(p["max_angular_correction_deg"])) + abs(
            math.atan(p["max_linear_correction"]
                      / math.hypot(p_i_w[0], p_i_w[1]))
        )
        rng = int(math.ceil(delta / angle_res))
        start_theta = math.atan2(p_i_w[1], p_i_w[0])
        if start_theta < ld.min_theta:
            start_theta += 2 * math.pi
        if start_theta > ld.max_theta:
            start_theta -= 2 * math.pi
        start_cell = int((start_theta - ld.min_theta)
                         / (ld.max_theta - ld.min_theta) * ld.nrays)
        from_ = min(max(0, start_cell - rng), ld.nrays - 1)
        to = min(max(0, start_cell + rng), ld.nrays - 1)
        return from_, to

    def _find_correspondences(self, laser_ref, laser_sens):
        p = self.p
        max_d2 = p["max_correspondence_dist"] ** 2
        for i in range(laser_sens.nrays):
            if not laser_sens.valid[i]:
                laser_sens.set_null_correspondence(i)
                continue
            p_i_w = laser_sens.points_w[i]
            j1 = -1
            best_dist = 1e4  # CSM's literal sentinel (best_dist = 10000)
            from_, to = self._possible_interval(p_i_w, laser_ref)
            for j in range(from_, to + 1):
                if not laser_ref.valid[j]:
                    continue
                d = p_i_w - laser_ref.points[j]
                dist = float(d @ d)
                if dist > max_d2:
                    continue
                if j1 == -1 or dist < best_dist:
                    j1 = j
                    best_dist = dist
            if j1 == -1 or j1 == 0 or j1 == laser_ref.nrays - 1:
                laser_sens.set_null_correspondence(i)
                continue
            j2up = laser_ref.next_valid(j1, +1)
            j2down = laser_ref.next_valid(j1, -1)
            if j2up == -1 and j2down == -1:
                laser_sens.set_null_correspondence(i)
                continue
            if j2up == -1:
                j2 = j2down
            elif j2down == -1:
                j2 = j2up
            else:
                du = p_i_w - laser_ref.points[j2up]
                dd = p_i_w - laser_ref.points[j2down]
                j2 = j2up if float(du @ du) < float(dd @ dd) else j2down
            laser_sens.corr_valid[i] = True
            laser_sens.corr_j1[i] = j1
            laser_sens.corr_j2[i] = j2
            laser_sens.corr_dist2[i] = best_dist

    def _kill_outliers_double(self, laser_ref, laser_sens):
        threshold = 3.0  # icp_outliers.c hard-coded
        dist2_j = np.full(laser_ref.nrays, 1e6)
        for i in range(laser_sens.nrays):
            if not laser_sens.corr_valid[i]:
                continue
            j1 = laser_sens.corr_j1[i]
            dist2_j[j1] = min(dist2_j[j1], laser_sens.corr_dist2[i])
        for i in range(laser_sens.nrays):
            if not laser_sens.corr_valid[i]:
                continue
            j1 = laser_sens.corr_j1[i]
            if laser_sens.corr_dist2[i] > threshold**2 * dist2_j[j1]:
                laser_sens.corr_valid[i] = False

    def _kill_outliers_trim(self, laser_ref, laser_sens):
        p = self.p
        dist = np.full(laser_sens.nrays, np.nan)
        dist2 = []
        for i in range(laser_sens.nrays):
            if not laser_sens.corr_valid[i]:
                continue
            j1, j2 = laser_sens.corr_j1[i], laser_sens.corr_j2[i]
            dist[i] = _dist_to_segment(
                laser_ref.points[j1], laser_ref.points[j2],
                laser_sens.points_w[i],
            )
            dist2.append(dist[i])
        k = len(dist2)
        if k == 0:
            return 0.0
        dist2 = np.sort(np.asarray(dist2))
        order = min(max(0, int(math.floor(k * p["outliers_maxPerc"]))), k - 1)
        error_limit1 = dist2[order]
        order2 = min(max(0, int(math.floor(k * p["outliers_adaptive_order"]))),
                     k - 1)
        error_limit2 = p["outliers_adaptive_mult"] * dist2[order2]
        error_limit = min(error_limit1, error_limit2)

        total_error = 0.0
        for i in range(laser_sens.nrays):
            if not laser_sens.corr_valid[i]:
                continue
            if dist[i] > error_limit:
                laser_sens.set_null_correspondence(i)
            else:
                total_error += dist[i]
        return total_error

    # ------------------------------------------------------------------
    def _compute_next_estimate(self, laser_ref, laser_sens, x_old):
        p = self.p
        corrs = []  # (p, q, C)
        for i in range(laser_sens.nrays):
            if not laser_sens.valid[i] or not laser_sens.corr_valid[i]:
                continue
            j1, j2 = laser_sens.corr_j1[i], laser_sens.corr_j2[i]
            pk = laser_sens.points[i]
            qk = laser_ref.points[j1]
            if p["use_point_to_line_distance"]:
                diff = laser_ref.points[j1] - laser_ref.points[j2]
                one_on_norm = 1.0 / math.hypot(diff[0], diff[1])
                normal = np.array([+diff[1], -diff[0]]) * one_on_norm
                C = np.outer(normal, normal)
            else:
                C = np.eye(2)
            corrs.append((pk, qk, C))
        if not corrs:
            return False, x_old.copy()
        ok, x_new = gpc_solve(corrs)
        if not ok:
            return False, x_old.copy()
        return True, x_new


def gpc_solve(corrs):
    """gpc/gpc.c: exact minimizer of sum (M_k x - q_k)' C_k (M_k x - q_k)
    over x = [tx, ty, cos, sin] with x[2:4] on the unit circle, greatest
    real root of the Schur-complement quartic (poly_greatest_real_root)."""
    d_bigM = np.zeros((4, 4))
    d_g = np.zeros(4)
    for pk, qk, C in corrs:
        px, py = float(pk[0]), float(pk[1])
        Mk = np.array([[1.0, 0.0, px, -py],
                       [0.0, 1.0, py, px]])
        d_bigM += Mk.T @ C @ Mk
        d_g += Mk.T @ C @ np.asarray(qk, np.float64)

    A = d_bigM[0:2, 0:2]
    B = d_bigM[0:2, 2:4]
    D = d_bigM[2:4, 2:4]
    g1 = d_g[0:2]
    g2 = d_g[2:4]
    try:
        Ainv = np.linalg.inv(A)
    except np.linalg.LinAlgError:
        return False, np.zeros(3)
    S = D - B.T @ Ainv @ B
    w = g2 - B.T @ Ainv @ g1
    # adj([[a,b],[c,d]]) = [[d,-b],[-c,a]]
    adjS = np.array([[S[1, 1], -S[0, 1]], [-S[1, 0], S[0, 0]]])
    b = float(np.trace(S))
    c = float(np.linalg.det(S))
    # (l^2 + b l + c)^2 - (w'w l^2 + 2 w'adjS w l + w'adjS^2 w) = 0
    poly = np.array([
        1.0,
        2.0 * b,
        b * b + 2.0 * c - float(w @ w),
        2.0 * b * c - 2.0 * float(w @ adjS @ w),
        c * c - float(w @ adjS @ adjS @ w),
    ])
    roots = np.roots(poly)
    real = roots[np.abs(roots.imag) < 1e-9 * (1.0 + np.abs(roots.real))].real
    if real.size == 0:
        return False, np.zeros(3)
    lam = float(np.max(real))
    try:
        theta_v = np.linalg.solve(S + lam * np.eye(2), w)
        t = Ainv @ (g1 - B @ theta_v)
    except np.linalg.LinAlgError:
        return False, np.zeros(3)
    return True, np.array([t[0], t[1], math.atan2(theta_v[1], theta_v[0])])


def gpc_total_error(corrs, x):
    """gpc.c gpc_total_error: objective at pose x = [tx, ty, theta]."""
    xv = np.array([x[0], x[1], math.cos(x[2]), math.sin(x[2])])
    err = 0.0
    for pk, qk, C in corrs:
        px, py = float(pk[0]), float(pk[1])
        Mk = np.array([[1.0, 0.0, px, -py],
                       [0.0, 1.0, py, px]])
        e = Mk @ xv - np.asarray(qk, np.float64)
        err += float(e @ C @ e)
    return err
