"""Reference-exact float64 oracle of the gmapping hit/visit grid mapper.

Scalar NumPy port of lesson4's gmapping node map computation
(``gmapping.cc:171-242``) over the vendored gmapping grid machinery,
preserving:

- ``world2map`` rounding: C ``round()`` — half-away-from-zero — of
  ``(p - center)/delta``, plus the half-size offset (map.h:171-175),
- ``GridLineTraversal::gridLineCore`` (gridlinetraversal.h:27-180): the
  classic Bresenham that always ENUMERATES FROM the endpoint with the
  smaller major-axis coordinate (x-major when ``dy <= dx``), so tie
  cells (exact half-cell crossings) follow the canonical direction, not
  the beam direction; the wrapper only reverses the order so the free
  trace can exclude the beam-endpoint cell (gmapping.cc:206-217 iterates
  ``num_points - 1``),
- the beam rules (gmapping.cc:186-218): skip ``d > maxRange``, ``d == 0``
  and non-finite beams; clamp ``d > maxUrange`` to maxUrange; record a
  hit (n++ AND visits++, PointAccumulator::update, map.h:36-48) only
  when ``d < maxUrange`` STRICTLY — an exactly-at-threshold beam marks
  free space only,
- visit MULTIPLICITY: every beam crossing a cell increments ``visits``
  independently (no per-scan dedup, unlike hector's log-odds update).

Used by tests/test_oracle_parity.py to differential-test
models/gmapping.py + ops/counts.py.  tpuslam's vectorized walk
enumerates start->end and rounds with floor(x + 0.5); both differ from
the reference ONLY on exact half-cell ties, which generic (non-grid-
aligned) fixtures never hit.
"""

from __future__ import annotations

import math

import numpy as np


def _c_round(v: float) -> int:
    """C round(): half away from zero."""
    return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))


def grid_line_core(x0, y0, x1, y1):
    """gridlinetraversal.h:27-180 — cells enumerated canonically."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    pts = []
    if dy <= dx:
        d = 2 * dy - dx
        incr1, incr2 = 2 * dy, 2 * (dy - dx)
        if x0 > x1:
            x, y, ydir, xend = x1, y1, -1, x0
        else:
            x, y, ydir, xend = x0, y0, 1, x1
        pts.append((x, y))
        up = (y1 - y0) * ydir > 0
        while x < xend:
            x += 1
            if d < 0:
                d += incr1
            else:
                y += 1 if up else -1
                d += incr2
            pts.append((x, y))
    else:
        d = 2 * dx - dy
        incr1, incr2 = 2 * dx, 2 * (dx - dy)
        if y0 > y1:
            x, y, xdir, yend = x1, y1, -1, y0
        else:
            x, y, xdir, yend = x0, y0, 1, y1
        pts.append((x, y))
        right = (x1 - x0) * xdir > 0
        while y < yend:
            y += 1
            if d < 0:
                d += incr1
            else:
                x += 1 if right else -1
                d += incr2
            pts.append((x, y))
    return pts


def grid_line(x0, y0, x1, y1):
    """gridLine wrapper: points[0] anchored at (x0, y0)."""
    pts = grid_line_core(x0, y0, x1, y1)
    if pts[0] != (x0, y0):
        pts.reverse()
    return pts


class OracleGmappingMap:
    """ComputeMap (gmapping.cc:171-242) over a dense counter grid."""

    def __init__(self, size_x: int, size_y: int, delta: float,
                 center_x: float, center_y: float):
        self.size_x, self.size_y = size_x, size_y
        self.delta = delta
        self.cx, self.cy = center_x, center_y
        self.n = np.zeros((size_y, size_x), np.int64)
        self.visits = np.zeros((size_y, size_x), np.int64)

    # map.h:171-175
    def world2map(self, x: float, y: float):
        return (
            _c_round((x - self.cx) / self.delta) + self.size_x // 2,
            _c_round((y - self.cy) / self.delta) + self.size_y // 2,
        )

    def compute_map(self, ranges, a_cos, a_sin, lp=(0.0, 0.0),
                    max_range=30.0, max_use_range=25.0):
        x0, y0 = self.world2map(lp[0], lp[1])
        for i, d in enumerate(np.asarray(ranges, np.float64)):
            if d > max_range or d == 0.0 or not np.isfinite(d):
                continue
            if d > max_use_range:
                d = max_use_range
            hx = lp[0] + d * a_cos[i]
            hy = lp[1] + d * a_sin[i]
            x1, y1 = self.world2map(hx, hy)
            line = grid_line(x0, y0, x1, y1)
            for cx, cy in line[:-1]:
                if 0 <= cx < self.size_x and 0 <= cy < self.size_y:
                    self.visits[cy, cx] += 1
            if d < max_use_range:
                if 0 <= x1 < self.size_x and 0 <= y1 < self.size_y:
                    self.n[y1, x1] += 1
                    self.visits[y1, x1] += 1

    def occupancy(self) -> np.ndarray:
        """-1 never visited, else n/visits."""
        out = np.full((self.size_y, self.size_x), -1.0)
        m = self.visits > 0
        out[m] = self.n[m] / self.visits[m]
        return out
