"""Hector SLAM's scan-to-map matcher as lesson4 runs it, and the map it is
run against, in plain PyTorch.

The map (:func:`build_map`) is the deployment's input, as weights are a
model's.  It is made from the first lap of a bag (the scans before the
course's heading has turned a full turn), at the scans' true poses, with
Hector's update (``OccGridMapBase.h:118-168, 220-330``, ``GridMapLogOdds.h:
92-161``): a scan updates the map where the pose has moved more than
``map_update_distance_thresh`` or ``map_update_angle_thresh`` since the last
update (``HectorSlamProcessor.h:101-107``; the first scan always); each level
is updated at its own resolution; each gated beam is a Bresenham line from
the sensor's cell to the endpoint's cell (a cell is the integer part of its
map coordinate + 0.5; a line whose ends are not both on the map, or that
ends where it starts, updates nothing); its cells before the endpoint get
logit(``update_factor_free``), the endpoint logit(``update_factor_occupied``)
while its log-odds are below 50; a cell is updated at most once a scan, and a
cell marked occupied in a scan is not also marked free.  Probabilities are
sigmoid(log-odds), 0.5 where nothing was seen.  The frame is scan 0's; the
grids are centred as ``map_start_x`` / ``map_start_y`` place them.

The matcher (:func:`relocalize`, ``ScanMatcher.h:60-139``,
``MapRepMultiMap.h:57-167``) runs, from the coarsest level to the finest,
``iterations_coarse`` Gauss-Newton iterations on each coarse level and
``iterations_finest`` on the finest, level i seeing the points scaled to its
cells.  An iteration takes Hector's bilinear value and gradient at each
transformed point (``OccGridMapUtil.h:77-132``; 0 off the map), the residual
1 - M, ``H = sum J^T J`` and ``dTr = sum J^T r`` over the gated beams on the
map, the step ``H^-1 dTr`` by the adjugate (none where |det H| <= 1e-12), its
yaw clamped to +-``yaw_step_clamp``.  It returns the pose, the H of the
finest level's last iteration (taken at the pose before its update) and the
score, the mean map value at that pose over the gated beams.  Beams are
gated as Hector gates them (``hector_slam.cc:336-356``): the strict range
window (``laser_min_dist``, ``laser_max_dist``), the mounting-shadow filter
(x < 0 and r^2 < 0.5) and ``use_max_scan_range``.  There is no crop window.

Everything is computed in the dtype of the grids handed in: float64 for the
reference, bfloat16 for the lower-precision control.  The program under
test departs from this description in its rounding alone: it samples a
bfloat16 copy of each grid; its finest level (``csrc/hector_gn.cu``) blends
the columns with tent weights ``1 - |col - x|`` over a bfloat16 row
difference and counts a beam only inside its crop window; its coarse levels
round the y weights to bfloat16.

Nothing here imports the program under test or JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.bag import relative
from portbench.reference.common import compose, transform, wrap

F64 = torch.float64
# GridMapLogOdds.h:110-114: an occupied update is made below this alone
LOG_ODDS_CAP = 50.0
# below this |det H| a Gauss-Newton step is skipped
DET_MIN = 1e-12


class World(NamedTuple):
    poses: torch.Tensor  # [S, 3] f64: each scan's true pose in scan 0's frame
    grids: tuple  # per level, finest first: [H_l, W_l] f64 probabilities


def logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def gate(params: dict, pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Hector's beam gate of points [..., B, 2] (hector_slam.cc:336-356)."""
    r2 = pts[..., 0] * pts[..., 0] + pts[..., 1] * pts[..., 1]
    r = torch.sqrt(r2)
    cap = params["use_max_scan_range"]
    return (valid & (r > params["laser_min_dist"])
            & (r < params["laser_max_dist"])
            & ~((pts[..., 0] < 0.0) & (r2 < 0.5)) & (r2 <= cap * cap))


def absolute_poses(truth: torch.Tensor) -> torch.Tensor:
    """[S, 3] f64: scan i's pose in scan 0's frame, composed from the
    relative poses ``truth`` [S - 1, 3] (scan i+1 in scan i's frame)."""
    th = torch.cat([truth.new_zeros(1), torch.cumsum(truth[:, 2], 0)])
    c, s = torch.cos(th[:-1]), torch.sin(th[:-1])
    dx = c * truth[:, 0] - s * truth[:, 1]
    dy = s * truth[:, 0] + c * truth[:, 1]
    x = torch.cat([truth.new_zeros(1), torch.cumsum(dx, 0)])
    y = torch.cat([truth.new_zeros(1), torch.cumsum(dy, 0)])
    return torch.stack([x, y, wrap(th)], dim=-1)


def levels(params: dict):
    """(resolution, cells a side, world origin x, y) of each level, finest
    first (MapRepMultiMap.h:57-90): the resolution doubles and the cells
    halve, over the same extent."""
    res, size = params["map_resolution"], params["map_size"]
    ox = -size * res * params["map_start_x"]
    oy = -size * res * params["map_start_y"]
    return [(res * 2 ** i, size >> i, ox, oy)
            for i in range(params["map_multi_res_levels"])]


def update_scans(params: dict, poses: torch.Tensor) -> list:
    """Indices of the first lap's scans that update the map: scan 0, then
    each scan that has moved more than the thresholds since the last."""
    p = poses.cpu()
    turned = torch.cat([p.new_zeros(1), torch.cumsum(
        wrap(p[1:, 2] - p[:-1, 2]), 0)]).abs()
    lap = int((turned < 2 * math.pi).sum())
    chosen, last = [0], p[0]
    for i in range(1, lap):
        d = p[i] - last
        if (math.hypot(float(d[0]), float(d[1]))
                > params["map_update_distance_thresh"]
                or abs(float(wrap(d[2]))) > params["map_update_angle_thresh"]):
            chosen.append(i)
            last = p[i]
    return chosen


def _update(lo, begin, ends, ok, steps: int, free: float, occ: float):
    """One scan's update of the log-odds ``lo`` [H, W]: begin [2] and ends
    [B, 2] in map coordinates, ok [B] the gated beams."""
    h, w = lo.shape
    b = (begin + 0.5).to(torch.int64)  # the int cast truncates, as C's
    e = (ends + 0.5).to(torch.int64)
    on_map = ((b[0] >= 0) & (b[0] < w) & (b[1] >= 0) & (b[1] < h)
              & (e[:, 0] >= 0) & (e[:, 0] < w)
              & (e[:, 1] >= 0) & (e[:, 1] < h))
    d = e - b
    n = d.abs().amax(-1)
    line = ok & on_map & (n > 0)
    k = torch.arange(steps, device=lo.device)
    nn = n.clamp(min=1)[:, None]
    # Bresenham's cells: k steps along the major axis, the minor one
    # rounded half up
    ax, ay = d[:, :1].abs(), d[:, 1:].abs()
    cx = b[0] + torch.sign(d[:, :1]) * ((2 * k * ax + nn) // (2 * nn))
    cy = b[1] + torch.sign(d[:, 1:]) * ((2 * k * ay + nn) // (2 * nn))
    drop = h * w
    free_at = torch.where(line[:, None] & (k < n[:, None]), cy * w + cx, drop)
    occ_at = torch.where(line, e[:, 1] * w + e[:, 0], drop)
    marks = []
    for at in (free_at, occ_at):
        m = torch.zeros(h * w + 1, dtype=torch.bool, device=lo.device)
        m[at.reshape(-1)] = True
        marks.append(m[:drop].reshape(h, w))
    is_free, is_occ = marks
    hit = torch.where(lo < LOG_ODDS_CAP, lo + occ, lo)
    return torch.where(is_occ, hit, torch.where(is_free, lo + free, lo))


def build_map(params: dict, points: torch.Tensor, valid: torch.Tensor,
              truth: torch.Tensor) -> World:
    """The map of a bag (points [S, B, 2], valid [S, B], truth [S - 1, 3]),
    in float64 on the bag's device."""
    poses = absolute_poses(truth.to(F64))
    chosen = update_scans(params, poses)
    idx = torch.tensor(chosen, device=points.device)
    pts = points[idx].to(F64)
    ok = gate(params, pts, valid[idx])
    at = poses[idx]
    world_pts = transform(at, pts)
    free = logit(params["update_factor_free"])
    occ = logit(params["update_factor_occupied"])
    reach = min(params["laser_max_dist"], params["use_max_scan_range"])
    grids = []
    for res, size, ox, oy in levels(params):
        origin = torch.tensor([ox, oy], dtype=F64, device=points.device)
        lo = torch.zeros((size, size), dtype=F64, device=points.device)
        steps = int(math.ceil(reach / res)) + 2
        for j in range(len(chosen)):
            lo = _update(lo, (at[j, :2] - origin) / res,
                         (world_pts[j] - origin) / res, ok[j], steps, free,
                         occ)
        grids.append(torch.sigmoid(lo))
    return World(poses=poses, grids=tuple(grids))


def _sample(grid, mx, my):
    """Hector's bilinear value and gradient at map coordinates (mx, my):
    (value, d/dx, d/dy, on the map), 0 off the map."""
    h, w = grid.shape
    fx0, fy0 = torch.floor(mx), torch.floor(my)
    # the cells' indices in integers: bfloat16 does not hold 2046
    ix, iy = fx0.to(torch.int64), fy0.to(torch.int64)
    on = ((ix >= 0) & (ix + 1 < w) & (iy >= 0) & (iy + 1 < h)
          & torch.isfinite(mx) & torch.isfinite(my))
    ix, iy = ix.clamp(0, w - 2), iy.clamp(0, h - 2)
    fx, fy = mx - fx0, my - fy0
    flat = grid.reshape(-1)
    base = iy * w + ix
    i0, i1 = flat[base], flat[base + 1]
    i2, i3 = flat[base + w], flat[base + w + 1]
    gx_, gy_ = 1.0 - fx, 1.0 - fy
    val = gy_ * (gx_ * i0 + fx * i1) + fy * (gx_ * i2 + fx * i3)
    dx = -((i0 - i1) * gy_ + (i2 - i3) * fy)
    dy = -((i0 - i2) * gx_ + (i1 - i3) * fx)
    zero = torch.zeros_like(val)
    return (torch.where(on, val, zero), torch.where(on, dx, zero),
            torch.where(on, dy, zero), on)


def _solve(h, dtr):
    """H^-1 dTr by the adjugate of the symmetric H [P, 3, 3]; (step, ok)."""
    a, b, c = h[:, 0, 0], h[:, 0, 1], h[:, 0, 2]
    d, e, f = h[:, 1, 1], h[:, 1, 2], h[:, 2, 2]
    det = a * (d * f - e * e) - b * (b * f - e * c) + c * (b * e - d * c)
    ok = det.abs() > DET_MIN
    det = torch.where(ok, det, torch.ones_like(det))
    inv = torch.stack([d * f - e * e, c * e - b * f, b * e - c * d,
                       c * e - b * f, a * f - c * c, b * c - a * e,
                       b * e - c * d, b * c - a * e, a * d - b * b],
                      -1).reshape(-1, 3, 3) / det[:, None, None]
    step = (inv * dtr[:, None, :]).sum(-1)
    return torch.where(ok[:, None], step, torch.zeros_like(step)), ok


def match_level(grid, pts, used, pose, iters: int, yaw_clamp: float):
    """``iters`` Gauss-Newton iterations against one level: pts [P, B, 2]
    and pose [P, 3] in its cells; (pose, H, score)."""
    px, py = pts[..., 0], pts[..., 1]
    n = used.sum(-1).clamp(min=1).to(pts.dtype)
    h = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(
        pose.shape[0], 3, 3)
    score = torch.zeros_like(pose[:, 0])
    for _ in range(iters):
        c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
        val, gx, gy, on = _sample(grid, c * px - s * py + pose[:, 0:1],
                                  s * px + c * py + pose[:, 1:2])
        on = on & used
        zero = torch.zeros_like(val)
        gx, gy = torch.where(on, gx, zero), torch.where(on, gy, zero)
        rot = (-s * px - c * py) * gx + (c * px - s * py) * gy
        r = torch.where(on, 1.0 - val, zero)
        jac = torch.stack([gx, gy, rot], -1)
        h = (jac[..., :, None] * jac[..., None, :]).sum(1)
        dtr = (jac * r[..., None]).sum(1)
        score = torch.where(on, val, zero).sum(-1) / n
        step, ok = _solve(h, dtr)
        step[:, 2] = step[:, 2].clamp(-yaw_clamp, yaw_clamp)
        pose = torch.where(ok[:, None], pose + step, pose)
    return pose, h, score


def relocalize(params: dict, grids, points, valid, prev, init) -> dict:
    """Each scan's match against the map: points [P, B, 2] and valid [P, B]
    of scans i+1, prev [P, 3] the true pose of scan i (f64) and init [P, 3]
    the guess of scan i+1 in scan i's frame.  The guess is prev after
    init; the matched pose is returned in scan i's true frame, with the
    finest H and the score, all in the grids' dtype."""
    dtype = grids[0].dtype
    pts = points.to(dtype)
    used = gate(params, pts, valid)
    prev = prev.to(dtype)
    pose = compose(prev, init.to(dtype))
    lv = levels(params)
    h = score = None
    for i in range(len(lv) - 1, -1, -1):
        res, _, ox, oy = lv[i]
        offset = torch.tensor([ox, oy], dtype=dtype, device=pts.device)
        pose_map = torch.cat([(pose[:, :2] - offset) / res, pose[:, 2:]], -1)
        iters = params["iterations_finest" if i == 0 else "iterations_coarse"]
        pose_map, h, score = match_level(grids[i], pts / res, used, pose_map,
                                         iters, params["yaw_step_clamp"])
        pose = torch.cat([pose_map[:, :2] * res + offset, pose_map[:, 2:]], -1)
    return {"pose": relative(prev, pose), "hessian": h, "score": score}
