"""Reference-exact float64 oracle of the hector GN scan matcher.

Scalar NumPy port of the reference's matcher contract, preserving its
exact op order and quirks:

- ``interpMapValueWithDerivatives`` (OccGridMapUtil.h:139-228): bilinear
  value + gradient with the repo's CORRECTED dx/dy factor pairing (the
  file keeps upstream hector's buggy lines commented out and returns the
  fixed ``-(dx1*yFacInv + dx2*fy)`` / ``-(dy1*xFacInv + dy2*fx)`` form);
  out-of-bounds points return (0, 0, 0) (OccGridMapUtil.h:141-144).
- ``getCompleteHessianDerivs`` (OccGridMapUtil.h:77-137): per-point
  residual 1 - M(Pm), rotational derivative, upper-triangle H built then
  symmetrized.
- ``estimateTransformationLogLh`` (ScanMatcher.h:110-140): update only
  when H(0,0) != 0 and H(1,1) != 0, searchDir = H^-1 dTr, yaw component
  clamped to +/-0.2 rad.
- ``matchData`` (ScanMatcher.h:62-100): ONE initial iteration plus
  maxIterations loop iterations (maxIterations + 1 total), final angle
  normalization, and H itself reported as the covariance.

Inputs are in the reference's working units: scan points in MAP-CELL
units of the level being matched (DataPointContainer.h:46-58 pre-scales
by 1/resolution) and poses in map coordinates.  Used by
tests/test_oracle_parity.py to differential-test match/hector.py.
"""

from __future__ import annotations

import math

import numpy as np


class OracleHectorMatcher:
    """float64 matchData for one pyramid level of ``prob_grid[y, x]``."""

    def __init__(self, prob_grid: np.ndarray):
        self.grid = np.asarray(prob_grid, np.float64)

    # OccGridMapUtil.h:139-228
    def interp_with_derivs(self, x: float, y: float):
        h, w = self.grid.shape
        # pointOutOfMapBounds + the interp's own x0+1/y0+1 reads: usable
        # interior is [0, size-1) on each axis
        if not (0.0 <= x and x < w - 1 and 0.0 <= y and y < h - 1):
            return 0.0, 0.0, 0.0
        x0 = int(x)
        y0 = int(y)
        fx = x - x0
        fy = y - y0
        p00 = self.grid[y0, x0]
        p10 = self.grid[y0, x0 + 1]
        p01 = self.grid[y0 + 1, x0]
        p11 = self.grid[y0 + 1, x0 + 1]
        dx1 = p00 - p10
        dx2 = p01 - p11
        dy1 = p00 - p01
        dy2 = p10 - p11
        xfi = 1.0 - fx
        yfi = 1.0 - fy
        val = (p00 * xfi + p10 * fx) * yfi + (p01 * xfi + p11 * fx) * fy
        gx = -(dx1 * yfi + dx2 * fy)
        gy = -(dy1 * xfi + dy2 * fx)
        return val, gx, gy

    # OccGridMapUtil.h:77-137
    def complete_hessian_derivs(self, pose: np.ndarray, pts: np.ndarray):
        s, c = math.sin(pose[2]), math.cos(pose[2])
        hess = np.zeros((3, 3), np.float64)
        dtr = np.zeros(3, np.float64)
        for px, py in np.asarray(pts, np.float64):
            tx = c * px - s * py + pose[0]
            ty = s * px + c * py + pose[1]
            val, gx, gy = self.interp_with_derivs(tx, ty)
            fun = 1.0 - val
            rot = (-s * px - c * py) * gx + (c * px - s * py) * gy
            dtr[0] += gx * fun
            dtr[1] += gy * fun
            dtr[2] += rot * fun
            hess[0, 0] += gx * gx
            hess[1, 1] += gy * gy
            hess[2, 2] += rot * rot
            hess[0, 1] += gx * gy
            hess[0, 2] += gx * rot
            hess[1, 2] += gy * rot
        hess[1, 0] = hess[0, 1]
        hess[2, 0] = hess[0, 2]
        hess[2, 1] = hess[1, 2]
        return hess, dtr

    # ScanMatcher.h:110-140
    def estimate_once(self, est: np.ndarray, pts: np.ndarray):
        hess, dtr = self.complete_hessian_derivs(est, pts)
        if hess[0, 0] != 0.0 and hess[1, 1] != 0.0:
            search = np.linalg.inv(hess) @ dtr
            if search[2] > 0.2:
                search[2] = 0.2
            elif search[2] < -0.2:
                search[2] = -0.2
            est = est + search
        return est, hess

    # ScanMatcher.h:62-100 (map coords in, map coords out)
    def match(self, begin_map: np.ndarray, pts: np.ndarray,
              max_iterations: int):
        est = np.asarray(begin_map, np.float64).copy()
        if len(pts) == 0:
            return est, np.zeros((3, 3))
        est, hess = self.estimate_once(est, pts)  # the initial iteration
        for _ in range(max_iterations):
            est, hess = self.estimate_once(est, pts)
        est[2] = math.atan2(math.sin(est[2]), math.cos(est[2]))
        return est, hess


class OracleHectorMap:
    """Reference-exact float64 log-odds map update (one pyramid level).

    Scalar port of ``updateByScan`` + ``updateLineBresenhami`` +
    ``bresenham2D`` + the updateIndex bookkeeping
    (OccGridMapBase.h:118-330) over ``GridMapLogOdds`` cell semantics
    (GridMapLogOdds.h:92-161), preserving:

    - the per-scan once-free/once-occupied marks and occ-unsets-free,
    - the one-sided saturation (occupied adds only while logOdds < 50,
      so a single update may overshoot past 50 and stays there; free
      has NO floor),
    - the (f + 0.5) int-cast rounding of begin/end cells,
    - whole-line cancellation when begin or end falls outside the map,
    - begin == end lines skipped entirely (no occ mark either),
    - free cells from the line start up to (excluding) the endpoint,
      with the reference's exact error seeding (abs_da / 2).
    """

    def __init__(self, size_x: int, size_y: int,
                 free_factor: float = 0.4, occ_factor: float = 0.9):
        self.size_x = size_x
        self.size_y = size_y
        self.log_odds = np.zeros(size_x * size_y)
        self.update_index = np.full(size_x * size_y, -1, np.int64)
        self.cur_update = 0
        self.lo_free = math.log(free_factor / (1.0 - free_factor))
        self.lo_occ = math.log(occ_factor / (1.0 - occ_factor))

    # GridMapLogOdds.h:108-131
    def _set_occ(self, off):
        if self.log_odds[off] < 50.0:
            self.log_odds[off] += self.lo_occ

    def _set_free(self, off):
        self.log_odds[off] += self.lo_free

    def _unset_free(self, off):
        self.log_odds[off] -= self.lo_free

    # OccGridMapBase.h:302-312
    def _cell_free(self, off, mark_free):
        if self.update_index[off] < mark_free:
            self._set_free(off)
            self.update_index[off] = mark_free

    # OccGridMapBase.h:315-330
    def _cell_occ(self, off, mark_free, mark_occ):
        if self.update_index[off] < mark_occ:
            if self.update_index[off] == mark_free:
                self._unset_free(off)
            self._set_occ(off)
            self.update_index[off] = mark_occ

    # OccGridMapBase.h:270-299
    def _bresenham2d(self, abs_da, abs_db, error_b, off_a, off_b, off,
                     mark_free):
        self._cell_free(off, mark_free)
        for _ in range(abs_da - 1):
            off += off_a
            error_b += abs_db
            if error_b >= abs_da:
                off += off_b
                error_b -= abs_da
            self._cell_free(off, mark_free)

    # OccGridMapBase.h:220-267
    def _update_line(self, x0, y0, x1, y1, mark_free, mark_occ):
        if not (0 <= x0 < self.size_x and 0 <= y0 < self.size_y):
            return
        if not (0 <= x1 < self.size_x and 0 <= y1 < self.size_y):
            return
        dx, dy = x1 - x0, y1 - y0
        abs_dx, abs_dy = abs(dx), abs(dy)
        off_dx = (dx > 0) - (dx < 0)
        off_dy = ((dy > 0) - (dy < 0)) * self.size_x
        start = y0 * self.size_x + x0
        if abs_dx >= abs_dy:
            self._bresenham2d(abs_dx, abs_dy, abs_dx // 2, off_dx, off_dy,
                              start, mark_free)
        else:
            self._bresenham2d(abs_dy, abs_dx, abs_dy // 2, off_dy, off_dx,
                              start, mark_free)
        self._cell_occ(y1 * self.size_x + x1, mark_free, mark_occ)

    # OccGridMapBase.h:118-168 (origo = laser origin in robot coords)
    def update_by_scan(self, pts_map, pose_map, origo=(0.0, 0.0)):
        mark_free = self.cur_update + 1
        mark_occ = self.cur_update + 2
        c, s = math.cos(pose_map[2]), math.sin(pose_map[2])

        def xform(p):
            return (c * p[0] - s * p[1] + pose_map[0],
                    s * p[0] + c * p[1] + pose_map[1])

        bx, by = xform(origo)
        x0, y0 = int(bx + 0.5), int(by + 0.5)
        for p in np.asarray(pts_map, np.float64):
            ex, ey = xform(p)
            x1, y1 = int(ex + 0.5), int(ey + 0.5)
            if (x0, y0) != (x1, y1):
                self._update_line(x0, y0, x1, y1, mark_free, mark_occ)
        self.cur_update += 3

    def update_by_scan_world(self, world_pts, begin_xy):
        """updateByScan with PRE-transformed endpoints: the reference
        transforms in Eigen float32 (Affine2f over float DataContainer),
        so bit-faithful cross-checks against an f32 pipeline must feed
        both sides the identical f32 world points."""
        mark_free = self.cur_update + 1
        mark_occ = self.cur_update + 2
        x0 = int(float(begin_xy[0]) + 0.5)
        y0 = int(float(begin_xy[1]) + 0.5)
        for ex, ey in np.asarray(world_pts, np.float64):
            x1, y1 = int(ex + 0.5), int(ey + 0.5)
            if (x0, y0) != (x1, y1):
                self._update_line(x0, y0, x1, y1, mark_free, mark_occ)
        self.cur_update += 3

    def grid(self) -> np.ndarray:
        return self.log_odds.reshape(self.size_y, self.size_x)
