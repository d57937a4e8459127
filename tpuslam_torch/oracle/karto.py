"""Float64 oracle of open_karto's correlative matcher + mapper graph.

Re-states the reference's exact numerical contract (lesson6/lib/open_karto)
in plain NumPy so tpuslam can be differential-tested against "what the C++
computes".  Every quantization and quirk is preserved deliberately:

- ``Round(v) = v >= 0 ? floor(v+0.5) : ceil(v-0.5)`` (Math.h:87-90) for all
  world->grid conversions (CoordinateConverter::WorldToGrid, Karto.h:4236-4252),
- grid rows are ALIGNED TO 8 cells (``m_WidthStep = AlignValue(width, 8)``,
  Karto.h:4458) and lookup offsets are FLAT-index deltas into that aligned
  array — an x-overflow wraps into the adjacent row exactly as the C++ does
  (GetResponse only checks ``0 <= idx < dataSize``, Mapper.cpp:819-856),
- point readings: the matcher consumes the UNFILTERED readings
  (``GetPointReadings()`` default wantFiltered=false, Karto.h:5336-5355) —
  every raw beam, including NaN/inf and out-of-[min,threshold] beams at
  their raw endpoints; the response denominator is the TOTAL beam count,
- the smear kernel is ``round(exp(-d^2/(2 sigma^2)) * 100)`` max-combined,
  half-size ``round(2 sigma / res)`` (Mapper.h:1032-1101), applied only when
  a cell is newly stamped occupied (Mapper.cpp:714-748),
- CorrelateScan tie handling: every candidate whose (penalized) response is
  within 1e-6 of the best is averaged, position arithmetic-mean, heading
  circular-mean (Mapper.cpp:455-487),
- the fine pass swaps angle parameters: searchAngleOffset =
  0.5 * coarse_angle_resolution, searchAngleResolution =
  fine_search_angle_offset (Mapper.cpp:274-282 — preserved verbatim),
- covariances: response-weighted second moments over the search-space prob
  grid / the angle sweep, with the reference's floors and MAX_VARIANCE=500
  fallbacks (Mapper.cpp:535-692).

The mapper graph (OracleMapper) ports Mapper::Process + MapperGraph
(Mapper.cpp:862-1414, 1999-2120): HasMovedEnough gating, the three edge
kinds, covariance-weighted pose fusion, running-scan window maintenance,
near-chain BFS, loop-closure candidate chains with the coarse/fine
accept gates, and CorrectPoses via the SPA2d oracle.

All scalars float64; loops are unvectorized where order matters (stamping)
and NumPy-vectorized only where bit-equivalent.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from tpuslam_torch.core.config import KartoConfig
from tpuslam_torch.oracle.spa2d import OracleSpa2d

KT_TOLERANCE = 1e-6
MAX_VARIANCE = 500.0
DISTANCE_PENALTY_GAIN = 0.2
ANGLE_PENALTY_GAIN = 0.2
GRID_OCCUPIED = 100
INVALID_SCAN = np.iinfo(np.int32).min  # sentinel, any impossible offset


def kt_round(v):
    """Math.h:87-90."""
    v = np.asarray(v, np.float64)
    return np.where(v >= 0.0, np.floor(v + 0.5), np.ceil(v - 0.5))


def norm_angle(a: float) -> float:
    """math::NormalizeAngle (full wrap to (-pi, pi])."""
    return math.atan2(math.sin(a), math.cos(a))


def _compose(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    return np.array(
        [a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
         norm_angle(a[2] + b[2])]
    )


def _inverse(p):
    c, s = math.cos(p[2]), math.sin(p[2])
    return np.array([-(c * p[0] + s * p[1]), -(-s * p[0] + c * p[1]), -p[2]])


def _relative(a, b):
    """b expressed in a's frame (karto Transform(a, Pose2()), Karto.h:2853+)."""
    return _compose(_inverse(a), b)


class OracleScan:
    """LocalizedRangeScan analog (Karto.h:5171-5480) with identity sensor
    offset (sensor pose == corrected pose, matching karto_slam.cc usage
    where the node pre-composes TF)."""

    def __init__(
        self,
        ranges,
        angle_min: float,
        angle_increment: float,
        *,
        range_threshold: float,
        minimum_range: float = 0.0,
        odom_pose=None,
        time: float = 0.0,
        sensor: str = "laser0",
    ):
        self.ranges = np.asarray(ranges, np.float64).copy()
        self.angle_min = float(angle_min)
        self.angle_increment = float(angle_increment)
        self.range_threshold = float(range_threshold)
        self.minimum_range = float(minimum_range)
        self.odom_pose = np.zeros(3) if odom_pose is None else np.asarray(
            odom_pose, np.float64).copy()
        self.corrected_pose = self.odom_pose.copy()
        self.time = float(time)
        self.sensor = sensor
        self.state_id = -1
        self.unique_id = -1
        self._dirty = True

    # sensor offset is identity: sensor pose == corrected pose
    @property
    def sensor_pose(self) -> np.ndarray:
        return self.corrected_pose

    def set_sensor_pose(self, pose) -> None:
        self.corrected_pose = np.asarray(pose, np.float64).copy()
        self._dirty = True

    def set_corrected_pose(self, pose) -> None:
        self.set_sensor_pose(pose)

    def _update(self) -> None:
        """LocalizedRangeScan::Update (Karto.h:5361-5427): unfiltered
        points for EVERY beam at raw endpoints (NaN propagates), filtered
        mask InRange(r, min, threshold), barycenter over filtered."""
        pose = self.sensor_pose
        beam = np.arange(self.ranges.shape[0], dtype=np.float64)
        angles = pose[2] + self.angle_min + beam * self.angle_increment
        with np.errstate(invalid="ignore"):
            self._unfiltered = np.stack(
                [pose[0] + self.ranges * np.cos(angles),
                 pose[1] + self.ranges * np.sin(angles)], axis=1
            )
            self._filtered_mask = (
                np.isfinite(self.ranges)
                & (self.ranges >= self.minimum_range)
                & (self.ranges <= self.range_threshold)
            )
        n = int(self._filtered_mask.sum())
        if n > 0:
            self._barycenter = self._unfiltered[self._filtered_mask].mean(0)
        else:
            self._barycenter = pose[:2].copy()
        self._dirty = False

    @property
    def unfiltered_points(self) -> np.ndarray:
        if self._dirty:
            self._update()
        return self._unfiltered

    @property
    def filtered_mask(self) -> np.ndarray:
        if self._dirty:
            self._update()
        return self._filtered_mask

    def reference_pose(self, use_barycenter: bool) -> np.ndarray:
        """GetReferencePose (Karto.h:5312-5338): barycenter position (with
        zero heading) or the sensor pose."""
        if self._dirty:
            self._update()
        if use_barycenter:
            return np.array([self._barycenter[0], self._barycenter[1], 0.0])
        return self.sensor_pose


def _align8(v: int) -> int:
    """math::AlignValue<kt_int32s>(width, 8) (Karto.h:4458)."""
    return (v + 7) & ~7


class OracleScanMatcher:
    """ScanMatcher (Mapper.cpp:119-856) on flat aligned arrays."""

    def __init__(
        self,
        search_size: float,
        resolution: float,
        smear_deviation: float,
        range_threshold: float,
        cfg: KartoConfig,
    ):
        assert resolution > 0 and search_size > 0 and range_threshold > 0
        assert smear_deviation >= 0
        self.cfg = cfg
        self.res = float(resolution)
        # ScanMatcher::Create (Mapper.cpp:126-172)
        side = int(kt_round(search_size / resolution)) + 1
        margin = int(math.ceil(range_threshold / resolution))
        grid_size = side + 2 * margin
        assert grid_size % 2 == 1
        # CorrelationGrid::CreateGrid (Mapper.h:912-933): border = half+1
        half = int(kt_round(2.0 * smear_deviation / resolution))
        border = half + 1
        self.half_kernel = half
        self.roi_xy = border
        self.roi_size = grid_size
        self.width = grid_size + 2 * border
        self.height = grid_size + 2 * border
        self.width_step = _align8(self.width)
        self.data = np.zeros((self.height, self.width_step), np.int32)
        self.data_size = self.width_step * self.height
        self.corr_offset = np.zeros(2)  # CoordinateConverter offset
        # smear kernel (Mapper.h:1032-1086)
        if smear_deviation > 0:
            ij = np.arange(-half, half + 1, dtype=np.float64)
            d = np.hypot(ij[None, :] * resolution, ij[:, None] * resolution)
            self.kernel = kt_round(
                np.exp(-0.5 * (d / smear_deviation) ** 2) * GRID_OCCUPIED
            ).astype(np.int32)
        else:
            self.kernel = np.array([[GRID_OCCUPIED]], np.int32)
        # search space probs grid (side x side, own converter)
        self.probs_side = side
        self.probs = np.zeros((side, side), np.float64)
        self.probs_offset = np.zeros(2)

    # -------------------------------------------------------- conversions
    def _world_to_grid(self, pts) -> np.ndarray:
        """CorrelationGrid converter: ROI-relative integer cells."""
        g = kt_round((np.asarray(pts, np.float64) - self.corr_offset) / self.res)
        with np.errstate(invalid="ignore"):
            return np.nan_to_num(g, nan=-(10**9)).astype(np.int64)

    def _grid_index(self, gxy) -> int:
        """CorrelationGrid::GridIndex (Mapper.h:940-947): +ROI then flat."""
        x = int(gxy[0]) + self.roi_xy
        y = int(gxy[1]) + self.roi_xy
        return x + y * self.width_step

    # ----------------------------------------------------------- stamping
    @staticmethod
    def find_valid_points(points: np.ndarray, viewpoint: np.ndarray):
        """FindValidPoints (Mapper.cpp:756-813): trailing-iterator culling
        of points on the wrong side of the viewpoint."""
        min_sq = 0.1 * 0.1
        first_point = None
        trailing = 0
        valid: list[np.ndarray] = []
        n = points.shape[0]
        for i in range(n):
            current = points[i]
            if first_point is None and not (
                np.isnan(current[0]) or np.isnan(current[1])
            ):
                first_point = current.copy()
            if first_point is None:
                continue
            delta = first_point - current
            with np.errstate(invalid="ignore"):
                far_enough = bool(delta @ delta > min_sq)
            if far_enough:
                a = viewpoint[1] - first_point[1]
                b = first_point[0] - viewpoint[0]
                c = (first_point[1] * viewpoint[0]
                     - first_point[0] * viewpoint[1])
                ss = current[0] * a + current[1] * b + c
                first_point = current.copy()
                if ss < 0.0:
                    trailing = i
                else:
                    for j in range(trailing, i):
                        valid.append(points[j])
                    trailing = i
        return valid

    def add_scans(self, base_scans, viewpoint) -> None:
        """AddScans/AddScan (Mapper.cpp:699-748)."""
        self.data[:] = 0
        for scan in base_scans:
            pts = self.find_valid_points(scan.unfiltered_points, viewpoint)
            for pt in pts:
                g = self._world_to_grid(pt)
                if not (0 <= g[0] < self.roi_size and 0 <= g[1] < self.roi_size):
                    continue
                gx, gy = int(g[0]) + self.roi_xy, int(g[1]) + self.roi_xy
                if self.data[gy, gx] == GRID_OCCUPIED:
                    continue
                self.data[gy, gx] = GRID_OCCUPIED
                # SmearPoint (Mapper.h:969-1005): kernel max-combine
                h = self.half_kernel
                if h > 0:
                    sl = self.data[gy - h : gy + h + 1, gx - h : gx + h + 1]
                    np.maximum(sl, self.kernel, out=sl)

    # ----------------------------------------------------------- lookups
    def _compute_offsets(self, scan: OracleScan, angle_center: float,
                         angle_offset: float, angle_resolution: float):
        """GridIndexLookup::ComputeOffsets (Karto.h:6407-6501): per angle,
        flat-index deltas of the scan's LOCAL unfiltered points rotated by
        the candidate angle.  NaN/inf RAW readings -> INVALID_SCAN."""
        n_angles = int(kt_round(angle_offset * 2.0 / angle_resolution)) + 1
        pose = scan.sensor_pose
        # local points: InverseTransformPose of the world unfiltered points
        c, s = math.cos(pose[2]), math.sin(pose[2])
        d = scan.unfiltered_points - pose[:2]
        with np.errstate(invalid="ignore"):
            local = np.stack(
                [c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]],
                axis=1,
            )
        invalid = ~np.isfinite(scan.ranges)
        start_angle = angle_center - angle_offset
        offsets = np.empty((n_angles, local.shape[0]), np.int64)
        angles = np.empty(n_angles)
        for ai in range(n_angles):
            angle = start_angle + ai * angle_resolution
            angles[ai] = angle
            ca, sa = math.cos(angle), math.sin(angle)
            rx = ca * local[:, 0] - sa * local[:, 1]
            ry = sa * local[:, 0] + ca * local[:, 1]
            # WorldToGrid(offset + gridOffset) - gridOffset cancels: the
            # delta is Round(rotated * scale), base-class flat index
            gx = kt_round(rx / self.res)
            gy = kt_round(ry / self.res)
            with np.errstate(invalid="ignore"):
                flat = np.where(
                    np.isfinite(gx) & np.isfinite(gy),
                    np.nan_to_num(gx, nan=0).astype(np.int64)
                    + np.nan_to_num(gy, nan=0).astype(np.int64)
                    * self.width_step,
                    INVALID_SCAN,
                )
            flat = np.where(invalid, INVALID_SCAN, flat)
            offsets[ai] = flat
        return offsets, angles

    def _get_response(self, offsets_row: np.ndarray, grid_index: int) -> float:
        """GetResponse (Mapper.cpp:819-856): numerator skips off-array and
        INVALID entries, denominator = TOTAL beam count * 100."""
        n_points = offsets_row.shape[0]
        if n_points == 0:
            return 0.0
        idx = grid_index + offsets_row
        ok = (offsets_row != INVALID_SCAN) & (idx >= 0) & (idx < self.data_size)
        resp = float(self.data.reshape(-1)[idx[ok]].sum())
        return resp / (n_points * GRID_OCCUPIED)

    # ------------------------------------------------------------- match
    def match_scan(self, scan: OracleScan, base_scans, *,
                   penalize: bool = True, refine: bool = True):
        """MatchScan (Mapper.cpp:184-291).  Returns (response, pose, cov)."""
        cfg = self.cfg
        scan_pose = scan.sensor_pose.copy()
        cov = np.eye(3)
        n_beams = scan.ranges.shape[0]
        if n_beams == 0:
            cov[0, 0] = cov[1, 1] = MAX_VARIANCE
            cov[2, 2] = 4.0 * cfg.coarse_angle_resolution**2
            return 0.0, scan_pose, cov
        # centre the correlation grid on the scan (Mapper.cpp:211-222)
        self.corr_offset = scan_pose[:2] - 0.5 * (self.roi_size - 1) * self.res
        self.add_scans(base_scans, scan_pose[:2])
        coarse_offset = 0.5 * (self.probs_side - 1) * self.res
        coarse_res = 2.0 * self.res

        best, mean, cov = self._correlate(
            scan, scan_pose, coarse_offset, coarse_res,
            cfg.coarse_search_angle_offset, cfg.coarse_angle_resolution,
            penalize, fine=False,
        )
        if cfg.use_response_expansion and abs(best) <= KT_TOLERANCE:
            new_offset = cfg.coarse_search_angle_offset
            for _ in range(3):
                new_offset += math.radians(20.0)
                best, mean, cov = self._correlate(
                    scan, scan_pose, coarse_offset, coarse_res,
                    new_offset, cfg.coarse_angle_resolution,
                    penalize, fine=False,
                )
                if abs(best) > KT_TOLERANCE:
                    break
        if refine:
            best, mean, cov2 = self._correlate(
                scan, mean, 0.5 * coarse_res, self.res,
                0.5 * cfg.coarse_angle_resolution,
                cfg.fine_search_angle_offset,
                penalize, fine=True, cov_in=cov,
            )
            cov = cov2
        return best, mean, cov

    def _correlate(self, scan, center, space_offset, space_res,
                   angle_offset, angle_res, penalize, fine, cov_in=None):
        """CorrelateScan (Mapper.cpp:309-523)."""
        cfg = self.cfg
        offsets, _ = self._compute_offsets(
            scan, center[2], angle_offset, angle_res
        )
        n_angles = offsets.shape[0]
        if not fine:
            self.probs[:] = 0.0
            self.probs_offset = center[:2] - space_offset

        n_x = int(kt_round(space_offset * 2.0 / space_res)) + 1
        n_y = n_x
        xs = -space_offset + np.arange(n_x) * space_res
        ys = -space_offset + np.arange(n_y) * space_res
        start_angle = center[2] - angle_offset

        responses = np.empty((n_y, n_x, n_angles))
        poses_xy = np.empty((n_y, n_x, 2))
        cand_angles = start_angle + np.arange(n_angles) * angle_res
        data_flat = self.data.reshape(-1)
        for yi, y in enumerate(ys):
            ny_pos = center[1] + y
            for xi, x in enumerate(xs):
                nx_pos = center[0] + x
                g = self._world_to_grid(np.array([nx_pos, ny_pos]))
                gi = self._grid_index(g)
                assert gi >= 0
                poses_xy[yi, xi] = (nx_pos, ny_pos)
                idx = gi + offsets  # [n_angles, B]
                ok = (
                    (offsets != INVALID_SCAN)
                    & (idx >= 0)
                    & (idx < self.data_size)
                )
                resp = np.where(ok, data_flat[np.clip(idx, 0, self.data_size - 1)], 0).sum(1)
                resp = resp / (offsets.shape[1] * GRID_OCCUPIED)
                if penalize:
                    sq_dist = x * x + y * y
                    dp = 1.0 - DISTANCE_PENALTY_GAIN * sq_dist / (
                        cfg.distance_variance_penalty**2
                    )
                    dp = max(dp, cfg.minimum_distance_penalty)
                    sq_ang = (cand_angles - center[2]) ** 2
                    ap = 1.0 - ANGLE_PENALTY_GAIN * sq_ang / (
                        cfg.angle_variance_penalty**2
                    )
                    ap = np.maximum(ap, cfg.minimum_angle_penalty)
                    resp = np.where(
                        np.abs(resp) <= KT_TOLERANCE, resp, resp * dp * ap
                    )
                responses[yi, xi] = resp

        best = float(responses.max()) if responses.size else -1.0
        if not fine:
            # save best response per PROBS cell (Mapper.cpp:435-452):
            # world->grid of the candidate position on the probs converter
            for yi in range(n_y):
                for xi in range(n_x):
                    g = kt_round(
                        (poses_xy[yi, xi] - self.probs_offset) / self.res
                    ).astype(np.int64)
                    if not (0 <= g[0] < self.probs_side
                            and 0 <= g[1] < self.probs_side):
                        raise RuntimeError("probs index out of range")
                    m = responses[yi, xi].max()
                    if m > self.probs[g[1], g[0]]:
                        self.probs[g[1], g[0]] = m

        # tie averaging (Mapper.cpp:455-487)
        tie = np.abs(responses - best) <= KT_TOLERANCE
        ties = np.argwhere(tie)
        pos = np.zeros(2)
        tx = ty = 0.0
        for yi, xi, ai in ties:
            pos += poses_xy[yi, xi]
            heading = norm_angle(cand_angles[ai])
            tx += math.cos(heading)
            ty += math.sin(heading)
        count = len(ties)
        assert count > 0
        pos /= count
        mean = np.array([pos[0], pos[1], math.atan2(ty / count, tx / count)])

        if not fine:
            cov = self._positional_covariance(
                mean, best, center, space_offset, space_res, angle_res
            )
        else:
            cov = np.eye(3) if cov_in is None else cov_in.copy()
            self._angular_covariance(
                mean, best, center, angle_offset, angle_res, offsets, cov
            )
        best = min(best, 1.0)
        return best, mean, cov

    def _positional_covariance(self, best_pose, best_response, center,
                               space_offset, space_res, angle_res):
        """ComputePositionalCovariance (Mapper.cpp:535-631)."""
        cov = np.eye(3)
        if best_response < KT_TOLERANCE:
            cov[0, 0] = cov[1, 1] = MAX_VARIANCE
            cov[2, 2] = 4.0 * angle_res**2
            return cov
        acc_xx = acc_xy = acc_yy = norm = 0.0
        dx = best_pose[0] - center[0]
        dy = best_pose[1] - center[1]
        n = int(kt_round(space_offset * 2.0 / space_res)) + 1
        for yi in range(n):
            y = -space_offset + yi * space_res
            for xi in range(n):
                x = -space_offset + xi * space_res
                g = kt_round(
                    (np.array([center[0] + x, center[1] + y])
                     - self.probs_offset) / self.res
                ).astype(np.int64)
                response = self.probs[int(g[1]), int(g[0])]
                if response >= best_response - 0.1:
                    norm += response
                    acc_xx += (x - dx) ** 2 * response
                    acc_xy += (x - dx) * (y - dy) * response
                    acc_yy += (y - dy) ** 2 * response
        if norm > KT_TOLERANCE:
            var_xx = max(acc_xx / norm, 0.1 * space_res**2)
            var_yy = max(acc_yy / norm, 0.1 * space_res**2)
            var_xy = acc_xy / norm
            mult = 1.0 / best_response
            cov[0, 0] = var_xx * mult
            cov[0, 1] = cov[1, 0] = var_xy * mult
            cov[1, 1] = var_yy * mult
            cov[2, 2] = 4.0 * angle_res**2
        if abs(cov[0, 0]) < KT_TOLERANCE:
            cov[0, 0] = MAX_VARIANCE
        if abs(cov[1, 1]) < KT_TOLERANCE:
            cov[1, 1] = MAX_VARIANCE
        return cov

    def _angular_covariance(self, best_pose, best_response, center,
                            angle_offset, angle_res, offsets, cov):
        """ComputeAngularCovariance (Mapper.cpp:641-692) — mutates cov[2,2]."""
        # NormalizeAngleDifference(best, center) (Math.h:221-234): shift
        # best by whole turns until it lies within center +- pi
        diff = best_pose[2] - center[2]
        while diff > math.pi:
            diff -= 2.0 * math.pi
        while diff < -math.pi:
            diff += 2.0 * math.pi
        best_angle = center[2] + diff
        g = self._world_to_grid(best_pose[:2])
        gi = self._grid_index(g)
        n_angles = int(kt_round(angle_offset * 2.0 / angle_res)) + 1
        start_angle = center[2] - angle_offset
        norm = acc = 0.0
        for ai in range(n_angles):
            angle = start_angle + ai * angle_res
            response = self._get_response(offsets[ai], gi)
            if response >= best_response - 0.1:
                norm += response
                acc += (angle - best_angle) ** 2 * response
        if norm > KT_TOLERANCE:
            if acc < KT_TOLERANCE:
                acc = angle_res**2
            acc /= norm
        else:
            acc = 1000.0 * angle_res**2
        cov[2, 2] = acc


@dataclasses.dataclass
class _Edge:
    source: int  # unique id
    target: int
    mean: np.ndarray  # pose difference in source frame (LinkInfo)
    precision: np.ndarray  # 3x3 information matrix


class OracleMapper:
    """Mapper::Process + MapperGraph (Mapper.cpp:862-1414, 1999-2120)."""

    def __init__(self, cfg: KartoConfig):
        self.cfg = cfg
        self.seq_matcher = OracleScanMatcher(
            cfg.correlation_search_space_dimension,
            cfg.correlation_search_space_resolution,
            cfg.correlation_search_space_smear_deviation,
            cfg.use_scan_range,
            cfg,
        )
        self.loop_matcher = OracleScanMatcher(
            cfg.loop_search_space_dimension,
            cfg.loop_search_space_resolution,
            cfg.loop_search_space_smear_deviation,
            cfg.use_scan_range,
            cfg,
        )
        self.scans: list[OracleScan] = []  # by unique id
        self.scans_by_sensor: dict[str, list[OracleScan]] = {}
        self.running: dict[str, list[OracleScan]] = {}
        self.last_scan: dict[str, OracleScan | None] = {}
        self.edges: list[_Edge] = []
        # adjacency in EDGE-INSERTION order per vertex (Vertex::AddEdge
        # push_back, Mapper.h:275-281) — BFS visit order depends on it;
        # edge-existence dedup is DIRECTED (AddEdge checks only
        # pEdge->GetTarget() == v2 over v1's incident edges,
        # Mapper.cpp:1077-1090, so a reverse edge is a new edge)
        self.adj: dict[int, list[int]] = {}
        self._edge_set: set[tuple[int, int]] = set()
        self.loop_closures = 0

    # ------------------------------------------------------------ process
    def process(self, scan: OracleScan) -> bool:
        """Mapper::Process (Mapper.cpp:1999-2079)."""
        cfg = self.cfg
        last = self.last_scan.get(scan.sensor)
        if last is not None:
            # corrected = T(last_odom -> last_corrected) o odom
            t = _compose(
                last.corrected_pose, _inverse(last.odom_pose)
            )
            scan.set_corrected_pose(_compose(t, scan.odom_pose))
        if not self._has_moved_enough(scan, last):
            return False
        cov = np.eye(3)
        if cfg.use_scan_matching and last is not None:
            _, best_pose, cov = self.seq_matcher.match_scan(
                scan, self.running[scan.sensor]
            )
            scan.set_sensor_pose(best_pose)
        # MapperSensorManager::AddScan: assign ids
        scan.unique_id = len(self.scans)
        sensor_list = self.scans_by_sensor.setdefault(scan.sensor, [])
        scan.state_id = len(sensor_list)
        self.scans.append(scan)
        sensor_list.append(scan)
        self.adj[scan.unique_id] = []
        self.running.setdefault(scan.sensor, [])
        if cfg.use_scan_matching:
            self._add_edges(scan, cov)
            self._add_running_scan(scan)
            if cfg.do_loop_closing:
                for sensor in list(self.scans_by_sensor):
                    self._try_close_loop(scan, sensor)
        self.last_scan[scan.sensor] = scan
        return True

    def _has_moved_enough(self, scan, last) -> bool:
        """Mapper::HasMovedEnough (Mapper.cpp:2087-2120)."""
        cfg = self.cfg
        if last is None:
            return True
        if scan.time - last.time >= cfg.minimum_time_interval:
            return True
        d_heading = norm_angle(scan.odom_pose[2] - last.odom_pose[2])
        if abs(d_heading) >= cfg.minimum_travel_heading:
            return True
        sq = float(
            (scan.odom_pose[:2] - last.odom_pose[:2])
            @ (scan.odom_pose[:2] - last.odom_pose[:2])
        )
        return sq >= cfg.minimum_travel_distance**2 - KT_TOLERANCE

    # -------------------------------------------------------------- edges
    def _link_scans(self, from_scan, to_scan, mean, cov) -> None:
        """LinkScans (Mapper.cpp:1104-1121) + LinkInfo (Mapper.h:110-152)."""
        key = (from_scan.unique_id, to_scan.unique_id)
        if key in self._edge_set:
            return  # edge exists: only new edges get labels/constraints
        self._edge_set.add(key)
        self.adj.setdefault(from_scan.unique_id, []).append(
            to_scan.unique_id
        )
        self.adj.setdefault(to_scan.unique_id, []).append(
            from_scan.unique_id
        )
        p1 = from_scan.sensor_pose
        diff = _relative(p1, mean)
        c, s = math.cos(-p1[2]), math.sin(-p1[2])
        r = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        cov_rot = r @ cov @ r.T
        self.edges.append(
            _Edge(
                from_scan.unique_id,
                to_scan.unique_id,
                diff,
                np.linalg.inv(cov_rot),
            )
        )

    def _link_chain_to_scan(self, chain, scan, mean, cov) -> None:
        """LinkChainToScan (Mapper.cpp:1152-1168)."""
        cfg = self.cfg
        pose = scan.reference_pose(cfg.use_scan_barycenter)
        closest = min(
            chain,
            key=lambda s: float(
                (s.reference_pose(cfg.use_scan_barycenter)[:2] - pose[:2])
                @ (s.reference_pose(cfg.use_scan_barycenter)[:2] - pose[:2])
            ),
        )
        cp = closest.reference_pose(cfg.use_scan_barycenter)
        sq = float((pose[:2] - cp[:2]) @ (pose[:2] - cp[:2]))
        if sq < cfg.link_scan_maximum_distance**2 + KT_TOLERANCE:
            self._link_scans(closest, scan, mean, cov)

    def _find_near_linked_scans(self, scan, max_distance):
        """FindNearLinkedScans via BFS (Mapper.h:542-613, 619-643)."""
        cfg = self.cfg
        center = scan.reference_pose(cfg.use_scan_barycenter)
        max_sq = max_distance**2

        def visit(s):
            p = s.reference_pose(cfg.use_scan_barycenter)
            sq = float((p[:2] - center[:2]) @ (p[:2] - center[:2]))
            return sq <= max_sq - KT_TOLERANCE

        to_visit = [scan.unique_id]
        seen = {scan.unique_id}
        valid = []
        while to_visit:
            uid = to_visit.pop(0)
            s = self.scans[uid]
            if visit(s):
                valid.append(s)
                for nb in self.adj.get(uid, ()):  # edge-insertion order
                    if nb not in seen:
                        seen.add(nb)
                        to_visit.append(nb)
        return valid

    def _find_near_chains(self, scan):
        """FindNearChains (Mapper.cpp:1171-1275)."""
        cfg = self.cfg
        scan_pose = scan.reference_pose(cfg.use_scan_barycenter)
        near = self._find_near_linked_scans(
            scan, cfg.link_scan_maximum_distance
        )
        processed: set[int] = set()
        chains = []
        for near_scan in near:
            if near_scan is scan or near_scan.unique_id in processed:
                continue
            processed.add(near_scan.unique_id)
            is_valid = True
            chain: list[OracleScan] = []
            sensor_list = self.scans_by_sensor[near_scan.sensor]
            for num in range(near_scan.state_id - 1, -1, -1):
                cand = sensor_list[num]
                if cand is scan:
                    is_valid = False
                p = cand.reference_pose(cfg.use_scan_barycenter)
                sq = float(
                    (scan_pose[:2] - p[:2]) @ (scan_pose[:2] - p[:2])
                )
                if sq < cfg.link_scan_maximum_distance**2 + KT_TOLERANCE:
                    chain.insert(0, cand)
                    processed.add(cand.unique_id)
                else:
                    break
            chain.append(near_scan)
            for num in range(near_scan.state_id + 1, len(sensor_list)):
                cand = sensor_list[num]
                if cand is scan:
                    is_valid = False
                p = cand.reference_pose(cfg.use_scan_barycenter)
                sq = float(
                    (scan_pose[:2] - p[:2]) @ (scan_pose[:2] - p[:2])
                )
                if sq < cfg.link_scan_maximum_distance**2 + KT_TOLERANCE:
                    chain.append(cand)
                    processed.add(cand.unique_id)
                else:
                    break
            if is_valid:
                chains.append(chain)
        return chains

    def _add_edges(self, scan, cov) -> None:
        """MapperGraph::AddEdges (Mapper.cpp:902-973)."""
        cfg = self.cfg
        last = self.last_scan.get(scan.sensor)
        means: list[np.ndarray] = []
        covs: list[np.ndarray] = []
        if last is not None:
            prev = self.scans_by_sensor[scan.sensor][scan.state_id - 1]
            self._link_scans(prev, scan, scan.sensor_pose, cov)
        if last is None:
            for sensor, scans in self.scans_by_sensor.items():
                if sensor == scan.sensor or not scans:
                    continue
                resp, best, c2 = self.seq_matcher.match_scan(scan, scans)
                self._link_scans(scans[0], scan, best, c2)
                if resp > cfg.link_match_minimum_response_fine:
                    means.append(best)
                    covs.append(c2)
        else:
            means.append(scan.sensor_pose.copy())
            covs.append(cov)
            self._link_chain_to_scan(
                self.running[scan.sensor], scan, scan.sensor_pose, cov
            )
        # LinkNearChains (Mapper.cpp:1124-1149)
        for chain in self._find_near_chains(scan):
            if len(chain) < cfg.loop_match_minimum_chain_size:
                continue
            resp, mean, c2 = self.seq_matcher.match_scan(
                scan, chain, penalize=False
            )
            if resp > cfg.link_match_minimum_response_fine - KT_TOLERANCE:
                means.append(mean)
                covs.append(c2)
                self._link_chain_to_scan(chain, scan, mean, c2)
        if means:
            scan.set_sensor_pose(self._weighted_mean(means, covs))

    @staticmethod
    def _weighted_mean(means, covs) -> np.ndarray:
        """ComputeWeightedMean (Mapper.cpp:1288-1330)."""
        inverses = [np.linalg.inv(c) for c in covs]
        inv_sum = np.linalg.inv(sum(inverses))
        acc = np.zeros(3)
        tx = ty = 0.0
        for mean, inv in zip(means, inverses):
            tx += math.cos(mean[2])
            ty += math.sin(mean[2])
            acc += (inv_sum @ inv) @ mean
        tx /= len(means)
        ty /= len(means)
        return np.array([acc[0], acc[1], math.atan2(ty, tx)])

    def _add_running_scan(self, scan) -> None:
        """ScanManager::AddRunningScan (Mapper.h:1365-1387)."""
        cfg = self.cfg
        run = self.running.setdefault(scan.sensor, [])
        run.append(scan)
        while True:
            front = run[0].sensor_pose
            back = run[-1].sensor_pose
            sq = float((front[:2] - back[:2]) @ (front[:2] - back[:2]))
            if (len(run) > cfg.scan_buffer_size
                    or sq > cfg.scan_buffer_maximum_scan_distance**2
                    - KT_TOLERANCE):
                run.pop(0)
            else:
                break

    # --------------------------------------------------------------- loop
    def _find_possible_loop_closure(self, scan, sensor, start_num):
        """FindPossibleLoopClosure (Mapper.cpp:1333-1394)."""
        cfg = self.cfg
        chain: list[OracleScan] = []
        pose = scan.reference_pose(cfg.use_scan_barycenter)
        near = {
            s.unique_id
            for s in self._find_near_linked_scans(
                scan, cfg.loop_search_maximum_distance
            )
        }
        scans = self.scans_by_sensor.get(sensor, [])
        num = start_num
        while num < len(scans):
            cand = scans[num]
            cp = cand.reference_pose(cfg.use_scan_barycenter)
            sq = float((cp[:2] - pose[:2]) @ (cp[:2] - pose[:2]))
            if sq < cfg.loop_search_maximum_distance**2 + KT_TOLERANCE:
                if cand.unique_id in near:
                    chain = []
                else:
                    chain.append(cand)
            else:
                if len(chain) >= cfg.loop_match_minimum_chain_size:
                    return chain, num
                chain = []
            num += 1
        if len(chain) >= cfg.loop_match_minimum_chain_size:
            return chain, num
        return [], num

    def _try_close_loop(self, scan, sensor) -> bool:
        """TryCloseLoop (Mapper.cpp:976-1051)."""
        cfg = self.cfg
        closed = False
        start = 0
        chain, start = self._find_possible_loop_closure(scan, sensor, start)
        while chain:
            coarse, best, cov = self.loop_matcher.match_scan(
                scan, chain, penalize=False, refine=False
            )
            # the variance gate value is SQUARED at set time
            # (setParamLoopMatchMaximumVarianceCoarse, Mapper.cpp:1871-1874)
            max_var = cfg.loop_match_maximum_variance_coarse**2
            if (coarse > cfg.loop_match_minimum_response_coarse
                    and cov[0, 0] < max_var
                    and cov[1, 1] < max_var):
                tmp = OracleScan(
                    scan.ranges, scan.angle_min, scan.angle_increment,
                    range_threshold=scan.range_threshold,
                    minimum_range=scan.minimum_range,
                    odom_pose=best, time=scan.time, sensor=scan.sensor,
                )
                tmp.set_sensor_pose(best)
                fine, best, cov = self.seq_matcher.match_scan(
                    tmp, chain, penalize=False
                )
                if fine >= cfg.loop_match_minimum_response_fine:
                    scan.set_sensor_pose(best)
                    self._link_chain_to_scan(chain, scan, best, cov)
                    self._correct_poses()
                    self.loop_closures += 1
                    closed = True
            chain, start = self._find_possible_loop_closure(
                scan, sensor, start
            )
        return closed

    def _correct_poses(self) -> None:
        """CorrectPoses (Mapper.cpp:1397-1414) via the SPA2d oracle."""
        spa = OracleSpa2d()
        for s in self.scans:
            spa.add_node(s.corrected_pose, s.unique_id)
        for e in self.edges:
            spa.add_constraint(e.source, e.target, e.mean, e.precision)
        spa.do_spa(40)
        for uid, pose in spa.get_poses().items():
            self.scans[uid].set_sensor_pose(pose)
