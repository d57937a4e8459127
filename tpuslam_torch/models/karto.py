"""Karto SLAM engine: correlative frontend + pose graph + loop closure
(counterpart of ``tpuslam/models/karto.py``, per-scan path).

The rebuild of lesson6 (karto_slam.cc + open_karto Mapper.cpp):

- **device**: the scan store and every correlative match
  (``match/correlative.py``, whose response surfaces and visibility
  filter run the hand-written CUDA kernels on a CUDA device) and the
  pose-graph solve (``graph/solver.py``),
- **host**: the graph bookkeeping of MapperGraph in float64 NumPy —
  running-window maintenance, near-chain BFS, loop-closure candidate
  chains, weighted-mean fusion.

Mapper::Process step by step (Mapper.cpp:1999-2079):

1. carry the last correction: ``corrected = last_corrected ∘ last_odom⁻¹ ∘
   odom`` (2021-2025),
2. HasMovedEnough on odometric poses (2087-2120),
3. match against the sensor's running window (2037-2045),
4. AddEdges (902-973): previous-scan link, running-chain link or the
   first-scan cross-sensor links, near-chain links, covariance-weighted
   mean fusion with a circular heading mean (1288-1330),
5. running window capped by count and span (Mapper.h:1356-1385),
6. loop closure (TryCloseLoop, 976-1051): coarse loop-grid match gated on
   response and variance, fine sequential-grid match, LinkChainToScan,
   CorrectPoses.

Float32 on the device, float64 in the host bookkeeping, exactly where the
JAX package has them.  ``process_batch``, the flush pipelines, the loop
and batch meshes and ``occupancy_grid`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.core import se2
from tpuslam_torch.core.config import KartoConfig
from tpuslam_torch.core.scan import Scan, scan_to_points
from tpuslam_torch.graph.backends import graph_from_edges, make_solver
from tpuslam_torch.match.correlative import CorrelativeSpec, match_scan
from tpuslam_torch.ops import correlative as ops_correlative


def _np_compose(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    return np.array(
        [
            a[0] + c * b[0] - s * b[1],
            a[1] + s * b[0] + c * b[1],
            math.atan2(math.sin(a[2] + b[2]), math.cos(a[2] + b[2])),
        ]
    )


def _np_inverse(p):
    c, s = math.cos(p[2]), math.sin(p[2])
    return np.array([-(c * p[0] + s * p[1]), -(-s * p[0] + c * p[1]), -p[2]])


def _np_relative(a, b):
    return _np_compose(_np_inverse(a), b)


def _gather_match(
    spec: CorrelativeSpec,
    pts_store: torch.Tensor,  # [M, B, 2] scan store (sensor-frame points)
    valid_store: torch.Tensor,  # [M, B]
    chain_idx: torch.Tensor,  # [n] chain scan ids
    chain_poses: torch.Tensor,  # [n, 3] chain poses
    center: torch.Tensor,  # [3] search centre
    local_pts: torch.Tensor,  # [B, 2] the query scan
    valid: torch.Tensor,  # [B]
    penalize: bool,
    refine: bool,
):
    """Chain gather + world transform + MatchScan."""
    wpts = se2.transform_points(chain_poses, pts_store[chain_idx])
    return match_scan(
        spec, center, local_pts, valid, wpts, valid_store[chain_idx],
        penalize=penalize, refine=refine,
    )


def _fused_seq_step(
    spec: CorrelativeSpec,
    pts_store: torch.Tensor,  # [M, B, 2], written in place at row sid
    valid_store: torch.Tensor,  # [M, B], written in place at row sid
    sid: int,
    scan: Scan,
    center: torch.Tensor,  # [3] odometry-carried prediction
    chain_idx: torch.Tensor,  # [n] running-chain ids
    chain_poses: torch.Tensor,  # [n, 3]
    max_range: float,
    do_match: bool,
):
    """The per-scan device side of Mapper::Process: polar to cartesian,
    store write, barycenter mean, running-chain match (Mapper.cpp:2037-2045).

    The matcher consumes the UNFILTERED readings (GetPointReadings(false),
    Karto.h:5336-5355): every finite beam takes part in visibility, grid
    stamping and the response.  Only the barycenter uses the
    range-filtered set (Karto.h:5361-5427).  The store is updated in place
    (the JAX version donates and returns it)."""
    pts, valid = scan_to_points(scan)
    valid = valid & (scan.ranges > 0.0)
    filtered = valid & (scan.ranges <= max_range)
    pts_store[sid] = pts
    valid_store[sid] = valid
    mean_local = torch.sum(
        torch.where(filtered[:, None], pts, 0.0), dim=0
    ) / torch.clamp_min(torch.sum(filtered), 1)
    if not do_match:
        return mean_local, None
    res = _gather_match(
        spec, pts_store, valid_store, chain_idx, chain_poses, center, pts,
        valid, penalize=True, refine=True,
    )
    return mean_local, res


class ProcessResult(NamedTuple):
    processed: bool
    pose: np.ndarray  # [3] corrected pose after matching/optimization
    response: float
    loop_closed: bool


@dataclasses.dataclass
class _ScanRecord:
    state_id: int
    odom_pose: np.ndarray
    time: float
    mean_local: np.ndarray  # [2] mean of valid local points (barycenter)
    sensor: str = "laser0"


def _spec(cfg: KartoConfig, resolution, search_dim, smear) -> CorrelativeSpec:
    return CorrelativeSpec(
        resolution=resolution,
        search_dim=search_dim,
        smear_deviation=smear,
        range_threshold=cfg.use_scan_range,
        coarse_angle_offset=cfg.coarse_search_angle_offset,
        coarse_angle_resolution=cfg.coarse_angle_resolution,
        fine_angle_offset=cfg.fine_search_angle_offset,
        distance_variance_penalty=cfg.distance_variance_penalty,
        angle_variance_penalty=cfg.angle_variance_penalty,
        minimum_distance_penalty=cfg.minimum_distance_penalty,
        minimum_angle_penalty=cfg.minimum_angle_penalty,
        use_response_expansion=cfg.use_response_expansion,
        response_method=cfg.response_method,
        count_invalid_in_denominator=cfg.count_invalid_in_denominator,
        num_readings=cfg.num_range_readings,
    )


class KartoMapper:
    """Stateful mapper mirroring ``karto::Mapper`` + ``MapperGraph``."""

    def __init__(
        self,
        cfg: KartoConfig,
        max_scans: int = 2048,
        events=None,
        device="cuda",
    ):
        """events: optional ``tpuslam.utils.events.EventBus`` (or any object
        with ``fire(event, **payload)``) — receives the reference's
        MapperListener stream (loop_closure_check, begin/end_loop_closure,
        poses_corrected; Mapper.cpp:2142-2218).

        device: where the scan store lives and every match and solve runs.
        On a CUDA device the patch-sum kernel is first checked once
        against its plain version (``ops.correlative.selfcheck``)."""
        self.cfg = cfg
        self.max_scans = max_scans
        self.events = events
        self.device = torch.device(device)
        if self.device.type == "cuda":
            ops_correlative.selfcheck(str(self.device))
        self.seq_spec = _spec(
            cfg,
            cfg.correlation_search_space_resolution,
            cfg.correlation_search_space_dimension,
            cfg.correlation_search_space_smear_deviation,
        )
        self.loop_spec = _spec(
            cfg,
            cfg.loop_search_space_resolution,
            cfg.loop_search_space_dimension,
            cfg.loop_search_space_smear_deviation,
        )
        b = cfg.num_beams
        # device-side scan store (local sensor-frame points, fixed capacity)
        self._pts = torch.zeros((max_scans, b, 2), dtype=torch.float32,
                                device=self.device)
        self._valid = torch.zeros((max_scans, b), dtype=torch.bool,
                                  device=self.device)
        # host-side metadata; scan ids are global, windows are per sensor
        self.records: list[_ScanRecord] = []
        self.poses = np.zeros((max_scans, 3))  # corrected sensor poses
        self.mean_locals = np.zeros((max_scans, 2))  # local-point means
        self.sensor_scans: dict[str, list[int]] = {}
        self.running_by_sensor: dict[str, list[int]] = {}
        self.edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self._edge_keys: set[tuple[int, int]] = set()  # AddEdge dedup
        self.adj: dict[int, set[int]] = {}
        self.last_by_sensor: dict[str, int] = {}
        self.stats = {
            "near_chain_links": 0,  # accepted LinkNearChains matches
            "pose_fusions": 0,  # ComputeWeightedMean writebacks
            "loop_closures": 0,
            "expansion_retries": 0,  # batch-mode retries (batch not ported)
            # every device->host fetch goes through _get
            "fetch_count": 0,
            "fetch_seconds": 0.0,
        }

    @classmethod
    def from_state(cls, cfg: KartoConfig, state: dict, device="cuda"):
        """A mapper that continues from ``state`` (see
        :func:`tpuslam_torch.convert.karto_state_from_numpy`)."""
        m = cls(cfg, max_scans=len(state["poses"]), device=device)
        m._pts.copy_(torch.as_tensor(state["_pts"], dtype=torch.float32))
        m._valid.copy_(torch.as_tensor(state["_valid"], dtype=torch.bool))
        m.poses[:] = state["poses"]
        m.mean_locals[:] = state["mean_locals"]
        m.records = [_ScanRecord(**r) for r in state["records"]]
        m.edges = list(state["edges"])
        m._edge_keys = set(state["_edge_keys"])
        m.adj = {k: set(v) for k, v in state["adj"].items()}
        m.sensor_scans = {k: list(v) for k, v in state["sensor_scans"].items()}
        m.running_by_sensor = {
            k: list(v) for k, v in state["running_by_sensor"].items()
        }
        m.last_by_sensor = dict(state["last_by_sensor"])
        m.stats.update(state["stats"])
        return m

    # ------------------------------------------------------------- helpers
    def _num(self) -> int:
        return len(self.records)

    def _barycenter(self, sid: int) -> np.ndarray:
        """GetReferencePose(use_scan_barycenter): mean world point
        (Karto.h:5312-5338); the pose if disabled."""
        if not self.cfg.use_scan_barycenter:
            return self.poses[sid][:2]
        p = self.poses[sid]
        c, s = math.cos(p[2]), math.sin(p[2])
        m = self.records[sid].mean_local
        return np.array(
            [p[0] + c * m[0] - s * m[1], p[1] + s * m[0] + c * m[1]]
        )

    def _bary_all(self) -> np.ndarray:
        """All scans' barycenters [n, 2], vectorised."""
        n = self._num()
        p = self.poses[:n]
        if not self.cfg.use_scan_barycenter:
            return p[:, :2]
        c, s = np.cos(p[:, 2]), np.sin(p[:, 2])
        m = self.mean_locals[:n]
        return np.stack(
            [
                p[:, 0] + c * m[:, 0] - s * m[:, 1],
                p[:, 1] + s * m[:, 0] + c * m[:, 1],
            ],
            axis=1,
        )

    def _chain_args(self, ids: list[int]):
        """Device chain ids and f32 chain poses for a match."""
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        poses = torch.as_tensor(
            self.poses[np.asarray(ids, np.int64)], dtype=torch.float32,
            device=self.device,
        )
        return idx, poses

    def _get(self, tensors):
        """Device->host copy with wall-time accounting: every match result
        of the mapper is fetched through here, so
        ``stats['fetch_count'/'fetch_seconds']`` record how often and how
        long the host waited on the device."""
        t0 = time.perf_counter()
        out = [t.cpu() for t in tensors]
        self.stats["fetch_seconds"] += time.perf_counter() - t0
        self.stats["fetch_count"] += 1
        return out

    def _match_async(
        self, spec, sid: int, center: np.ndarray, chain: list[int],
        penalize: bool, refine: bool,
    ):
        """Queue one chain match; its result stays on the device."""
        idx, poses = self._chain_args(chain)
        return _gather_match(
            spec, self._pts, self._valid, idx, poses,
            torch.as_tensor(center, dtype=torch.float32, device=self.device),
            self._pts[sid], self._valid[sid],
            penalize=penalize, refine=refine,
        )

    def _fetch_matches(self, results):
        """Settle queued matches with ONE fetch: [(pose f64, response,
        cov f64), ...]."""
        flat = self._get(
            [t for r in results for t in (r.pose, r.response, r.covariance)]
        )
        return [
            (
                flat[k].numpy().astype(np.float64),
                float(flat[k + 1]),
                flat[k + 2].numpy().astype(np.float64),
            )
            for k in range(0, len(flat), 3)
        ]

    def _match(
        self, spec, sid: int, center: np.ndarray, chain: list[int],
        penalize: bool, refine: bool,
    ):
        """Match scan ``sid`` against ``chain``: (pose f64, response, cov f64)."""
        res = self._match_async(spec, sid, center, chain, penalize, refine)
        return self._fetch_matches([res])[0]

    def _add_edge(self, i: int, j: int, mean: np.ndarray, cov: np.ndarray):
        """LinkScans (Mapper.cpp:1105-1121): constraint = from-pose → mean,
        precision = the inverse of the covariance rotated into the from
        scan's frame, eigen-floored at 1e-4 so a degenerate response
        plateau cannot explode it."""
        if (i, j) in self._edge_keys:
            return  # AddEdge dedup (Mapper.cpp:1086-1096)
        self._edge_keys.add((i, j))
        meas = _np_relative(self.poses[i], mean)
        th = float(self.poses[i][2])
        c, s = math.cos(-th), math.sin(-th)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        sym = 0.5 * (cov + cov.T)
        sym = rot @ sym @ rot.T
        w, v = np.linalg.eigh(sym)
        prec = (v / np.maximum(w, 1e-4)) @ v.T
        self.edges.append((i, j, meas, prec))
        self.adj.setdefault(i, set()).add(j)
        self.adj.setdefault(j, set()).add(i)

    def _closest_in_chain(self, chain: list[int], ref_xy: np.ndarray) -> int:
        ds = [
            float(np.sum((self._barycenter(s) - ref_xy) ** 2)) for s in chain
        ]
        return chain[int(np.argmin(ds))]

    def _link_chain_to_scan(
        self, chain: list[int], sid: int, mean: np.ndarray, cov: np.ndarray
    ) -> bool:
        """Mapper.cpp:1155-1170: edge from the chain scan closest to sid.
        Returns whether the link passed the distance gate."""
        ref = self._barycenter(sid)
        closest = self._closest_in_chain(chain, ref)
        d2 = float(np.sum((self._barycenter(closest) - ref) ** 2))
        if d2 < self.cfg.link_scan_maximum_distance**2 + 1e-9:
            self._add_edge(closest, sid, mean, cov)
            return True
        return False

    def _find_near_linked(
        self, sid: int, max_distance: float, d2_all: np.ndarray | None = None
    ) -> set[int]:
        """BFS from sid over graph edges, keeping scans whose barycenter is
        within max_distance (Mapper.cpp:1280-1292 NearScanVisitor)."""
        if d2_all is None:
            bary = self._bary_all()
            d2_all = np.sum((bary - bary[sid]) ** 2, axis=1)
        seen = {sid}
        out: set[int] = set()
        frontier = [sid]
        maxd2 = max_distance**2 + 1e-9
        while frontier:
            nxt = []
            for v in frontier:
                for w in self.adj.get(v, ()):
                    if w in seen:
                        continue
                    seen.add(w)
                    if d2_all[w] < maxd2:
                        out.add(w)
                        nxt.append(w)
            frontier = nxt
        return out

    def _find_near_chains(self, sid: int) -> list[list[int]]:
        """Mapper.cpp:1173-1275: grow each near-linked scan into a chain
        along state ids while within link_scan_maximum_distance; chains
        containing sid are invalid."""
        bary = self._bary_all()
        d2_all = np.sum((bary - bary[sid]) ** 2, axis=1)
        maxd2 = self.cfg.link_scan_maximum_distance**2 + 1e-9
        near = self._find_near_linked(
            sid, self.cfg.link_scan_maximum_distance, d2_all
        )
        processed: set[int] = set()
        chains: list[list[int]] = []
        for ns in sorted(near):
            if ns == sid or ns in processed:
                continue
            processed.add(ns)
            seq = self.sensor_scans[self.records[ns].sensor]
            pos = seq.index(ns)
            chain = [ns]
            valid = True
            for k in range(pos - 1, -1, -1):
                cand = seq[k]
                if cand == sid:
                    valid = False
                if d2_all[cand] < maxd2:
                    chain.insert(0, cand)
                    processed.add(cand)
                else:
                    break
            for k in range(pos + 1, len(seq)):
                cand = seq[k]
                if cand == sid:
                    valid = False
                if d2_all[cand] < maxd2:
                    chain.append(cand)
                    processed.add(cand)
                else:
                    break
            if valid:
                chains.append(chain)
        return chains

    def _weighted_mean(self, means, covs) -> np.ndarray:
        """Mapper.cpp:1288-1330 covariance-weighted mean, circular heading."""
        invs = [np.linalg.inv(c + 1e-12 * np.eye(3)) for c in covs]
        wsum = np.linalg.inv(sum(invs))
        acc = np.zeros(3)
        tx = ty = 0.0
        for m, inv in zip(means, invs):
            acc += wsum @ inv @ m
            tx += math.cos(m[2])
            ty += math.sin(m[2])
        acc[2] = math.atan2(ty / len(means), tx / len(means))
        return acc

    # ------------------------------------------------------------- process
    def process(
        self, scan: Scan, odom_pose, time: float = 0.0,
        sensor: str = "laser0",
    ) -> ProcessResult:
        odom_pose = np.asarray(odom_pose, np.float64)
        cfg = self.cfg
        last_id = self.last_by_sensor.get(sensor)
        running = self.running_by_sensor.setdefault(sensor, [])

        if self._num() >= self.max_scans:
            return ProcessResult(False, odom_pose, 0.0, False)

        # 1. carry forward last correction (Mapper.cpp:2021-2025)
        if last_id is not None:
            last = self.records[last_id]
            corrected = _np_compose(
                _np_compose(
                    self.poses[last_id], _np_inverse(last.odom_pose)
                ),
                odom_pose,
            )
        else:
            corrected = odom_pose.copy()

        # 2. HasMovedEnough (Mapper.cpp:2087-2120) on ODOMETRIC poses
        if last_id is not None:
            last = self.records[last_id]
            dt = time - last.time
            dh = abs(
                math.atan2(
                    math.sin(odom_pose[2] - last.odom_pose[2]),
                    math.cos(odom_pose[2] - last.odom_pose[2]),
                )
            )
            d2 = float(np.sum((odom_pose[:2] - last.odom_pose[:2]) ** 2))
            if not (
                dt >= cfg.minimum_time_interval
                or dh >= cfg.minimum_travel_heading
                or d2 >= cfg.minimum_travel_distance**2 - 1e-9
            ):
                return ProcessResult(False, corrected, 0.0, False)

        # 3. stage the scan on the device + sequential match against this
        #    sensor's running scans (Mapper.cpp:2037-2045)
        sid = self._num()
        do_match = bool(cfg.use_scan_matching and last_id is not None)
        idx, chain_poses = self._chain_args(running)
        mean_local, res = _fused_seq_step(
            self.seq_spec,
            self._pts,
            self._valid,
            sid,
            scan.to(self.device),
            torch.as_tensor(corrected, dtype=torch.float32,
                            device=self.device),
            idx,
            chain_poses,
            max_range=cfg.use_scan_range,
            do_match=do_match,
        )
        if do_match:
            mean_local, best, response, dcov = self._get(
                (mean_local, res.pose, res.response, res.covariance)
            )
            corrected = best.numpy().astype(np.float64)
            response = float(response)
            cov = dcov.numpy().astype(np.float64)
        else:
            (mean_local,) = self._get((mean_local,))
            response = 1.0
            cov = np.eye(3)
        return self._finish_scan(
            sid, corrected, response, cov, mean_local.numpy(), odom_pose,
            time, sensor, running, last_id,
        )

    def _finish_scan(
        self, sid, corrected, response, cov, mean_local, odom_pose, time,
        sensor, running, last_id,
    ) -> ProcessResult:
        """Host bookkeeping after the device match: record + AddEdges +
        window maintenance + loop closure (Mapper::Process steps 4-6)."""
        cfg = self.cfg
        self.poses[sid] = corrected
        self.mean_locals[sid] = mean_local
        self.records.append(
            _ScanRecord(sid, odom_pose, time, mean_local, sensor)
        )
        self.sensor_scans.setdefault(sensor, []).append(sid)

        loop_closed = False
        if cfg.use_scan_matching:
            # 4. edges (AddEdges, Mapper.cpp:902-973): previous-scan link,
            # then EITHER the first-scan-of-sensor cross-sensor links OR
            # the running-chain link (whose mean/cov joins the fusion set),
            # then, for EVERY scan, LinkNearChains and the fusion
            means, covs = [], []
            if last_id is not None:
                self._add_edge(last_id, sid, corrected, cov)
                means.append(corrected.copy())
                covs.append(cov)
                self._link_chain_to_scan(running, sid, corrected, cov)
            else:
                # first scan of this sensor: link to the first scan of every
                # OTHER sensor via a sequential match (Mapper.cpp:923-953)
                for other, oscans in self.sensor_scans.items():
                    if other == sensor or not oscans or oscans == [sid]:
                        continue
                    mean_o, resp_o, cov_o = self._match(
                        self.seq_spec,
                        sid,
                        self.poses[sid],
                        [x for x in oscans if x != sid],
                        penalize=True,
                        refine=True,
                    )
                    self._add_edge(oscans[0], sid, mean_o, cov_o)
                    if resp_o > cfg.link_match_minimum_response_fine:
                        means.append(mean_o)
                        covs.append(cov_o)

            # near chains, unconditionally (LinkNearChains, Mapper.cpp:965;
            # chains containing sid are invalid, the match is unpenalized)
            # All chains share the centre pose (fusion applies after the
            # loop): queue them all and settle them with ONE fetch
            chains = [
                c for c in self._find_near_chains(sid)
                if len(c) >= cfg.loop_match_minimum_chain_size
            ]
            ress = [
                self._match_async(
                    self.seq_spec, sid, self.poses[sid], c,
                    penalize=False, refine=True,
                )
                for c in chains
            ]
            for chain, (mean_c, resp_c, cov_c) in zip(
                chains, self._fetch_matches(ress)
            ):
                if resp_c > cfg.link_match_minimum_response_fine - 1e-9:
                    means.append(mean_c)
                    covs.append(cov_c)
                    self._link_chain_to_scan(chain, sid, mean_c, cov_c)
                    self.stats["near_chain_links"] += 1
            # multi-match fusion (ComputeWeightedMean, Mapper.cpp:969-972)
            if means:
                self.poses[sid] = self._weighted_mean(means, covs)
                self.stats["pose_fusions"] += 1

            # 5. running window maintenance (Mapper.h:1356-1385)
            running.append(sid)
            while len(running) > cfg.scan_buffer_size:
                running.pop(0)
            while running and (
                np.sum(
                    (
                        self._barycenter(running[0])
                        - self._barycenter(running[-1])
                    )
                    ** 2
                )
                > cfg.scan_buffer_maximum_scan_distance**2
            ):
                running.pop(0)

            # 6. loop closure, against every sensor's history
            # (Mapper::Process loops device names, Mapper.cpp:2063-2070)
            if cfg.do_loop_closing:
                for sname in self.sensor_scans:
                    loop_closed |= self._try_close_loop(sid, sname)

        self.last_by_sensor[sensor] = sid
        return ProcessResult(True, self.poses[sid].copy(), response, loop_closed)

    # --------------------------------------------------------- loop closure
    def _find_possible_loop_closure(
        self, sid: int, sensor: str, start: int
    ) -> tuple[list[int], int]:
        """FindPossibleLoopClosure (Mapper.cpp:1333-1394): the NEXT candidate
        chain of the sensor's history, resuming from scan index ``start``.
        Returns (chain, next_start); re-evaluated after every accepted
        closure so later candidates see the corrected poses."""
        cfg = self.cfg
        bary = self._bary_all()
        d2_all = np.sum((bary - bary[sid]) ** 2, axis=1)
        near = self._find_near_linked(
            sid, cfg.loop_search_maximum_distance, d2_all
        )
        scans = self.sensor_scans.get(sensor, [])
        chain: list[int] = []
        i = start
        while i < len(scans):
            cand = scans[i]
            i += 1
            if d2_all[cand] < cfg.loop_search_maximum_distance**2 + 1e-9:
                # a near-linked scan (or sid itself) breaks the chain
                if cand == sid or cand in near:
                    chain = []
                else:
                    chain.append(cand)
            else:
                if len(chain) >= cfg.loop_match_minimum_chain_size:
                    return chain, i
                chain = []
        if len(chain) >= cfg.loop_match_minimum_chain_size:
            return chain, i
        return [], i

    def _try_close_loop(self, sid: int, sensor: str) -> bool:
        cfg = self.cfg
        closed = False
        start = 0
        chain, start = self._find_possible_loop_closure(sid, sensor, start)
        while chain:
            best, coarse_resp, cov = self._match(
                self.loop_spec, sid, self.poses[sid], chain,
                penalize=False, refine=False,
            )
            if self.events is not None:
                self.events.fire(
                    "loop_closure_check",
                    scan=sid,
                    chain_len=len(chain),
                    coarse_response=coarse_resp,
                    var_xx=float(cov[0, 0]),
                    var_yy=float(cov[1, 1]),
                )
            # the variance gate compares against the SQUARED parameter
            # (Mapper.cpp:1873, consumed at 1004-1005)
            if (
                coarse_resp > cfg.loop_match_minimum_response_coarse
                and cov[0, 0] < cfg.loop_match_maximum_variance_coarse**2
                and cov[1, 1] < cfg.loop_match_maximum_variance_coarse**2
            ):
                # fine pass matches the FULL chain (Mapper.cpp:1015-1016)
                fine, fine_resp, fine_cov = self._match(
                    self.seq_spec, sid, best, chain,
                    penalize=False, refine=True,
                )
                if fine_resp >= cfg.loop_match_minimum_response_fine:
                    # accept only if LinkChainToScan's distance gate passes:
                    # the reference's solver would overwrite an edge-less
                    # pose reset at once, so skipping it is the net no-op
                    ref_b = self._barycenter(sid)
                    closest = self._closest_in_chain(chain, ref_b)
                    d2 = float(
                        np.sum((self._barycenter(closest) - ref_b) ** 2)
                    )
                    if d2 < cfg.link_scan_maximum_distance**2 + 1e-9:
                        if self.events is not None:
                            self.events.fire(
                                "begin_loop_closure", scan=sid,
                                fine_response=fine_resp,
                            )
                        self.poses[sid] = fine
                        self._link_chain_to_scan(chain, sid, fine, fine_cov)
                        self.correct_poses()
                        closed = True
                        self.stats["loop_closures"] += 1
                        if self.events is not None:
                            self.events.fire("end_loop_closure", scan=sid)
            chain, start = self._find_possible_loop_closure(sid, sensor, start)
        return closed

    def correct_poses(self):
        """CorrectPoses (Mapper.cpp:1397-1414): run the configured backend
        (cfg.solver_type) on the device and write the corrected poses back
        into every scan."""
        if not self.cfg.use_back_end or not self.edges:
            return
        n = self._num()
        g = graph_from_edges(self.poses[:n], self.edges, device=self.device)
        poses, stats = make_solver(self.cfg.solver_type).compute(g)
        self.poses[:n] = poses.cpu().numpy().astype(np.float64)
        if self.events is not None:
            self.events.fire(
                "poses_corrected",
                nodes=n,
                edges=len(self.edges),
                initial_cost=float(stats.initial_cost),
                final_cost=float(stats.final_cost),
            )
