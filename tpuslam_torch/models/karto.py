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

Offline, ``process_batch`` issues the device side of a flush of scans
back to back with no host read (sequentially chained, or in parallel from
odometry-chained predictions, optionally pipelined over several flushes)
and settles the host bookkeeping after one fetch a flush;
``occupancy_grid`` exports the map (CreateFromScans).

Float32 on the device, float64 in the host bookkeeping, exactly where the
JAX package has them.  Two device meshes (``tpuslam_torch/parallel``) are
optional: ``loop_mesh`` shards the coarse loop search's angles, and
``batch_mesh`` the matches of a ``process_batch(parallel=True)`` flush;
either gives the unsharded mapper's results bit for bit.
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
from tpuslam_torch.core.grid import GridSpec
from tpuslam_torch.core.scan import Scan, near_of
from tpuslam_torch.core.xla_cpu import clipped_endpoints as _clipped_endpoints
from tpuslam_torch.core.xla_cpu import cos_sin_f32 as _cos_sin_f32
from tpuslam_torch.graph.backends import graph_from_edges, make_solver
from tpuslam_torch.match.correlative import CorrelativeSpec, match_scan
from tpuslam_torch.ops import correlative as ops_correlative
from tpuslam_torch.ops.counts import accumulate_scan, karto_export, zero_counts
from tpuslam_torch.parallel.correlative import make_sharded_match_scan
from tpuslam_torch.parallel.mesh import Replicas, on, split

# occupancy_grid: ray steps (scans x beams x steps) traced at once
_MAP_CHUNK = 1 << 23


# the edge covariances' eigenvalue floor (KartoMapper._add_edge)
_COV_FLOOR = 1e-9


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
    wpts, wvalid = _gather_chain(pts_store, valid_store, chain_idx,
                                 chain_poses)
    return match_scan(spec, center, local_pts, valid, wpts, wvalid,
                      penalize=penalize, refine=refine)


def _gather_chain(pts_store, valid_store, chain_idx, chain_poses):
    """A chain's points in the world frame [n, B, 2] and their validity."""
    return (se2.transform_points(chain_poses, pts_store[chain_idx]),
            valid_store[chain_idx])


def matcher_points(scan: Scan):
    """The matcher's points of a scan (sensor frame) and their mask: the
    UNFILTERED readings (GetPointReadings(false), Karto.h:5336-5355), the
    ``valid`` beams and the ``near`` ones below range_min (which
    ``make_scan`` keeps, masked from ``valid``).  Each takes part in
    visibility, grid stamping and the response, as in
    LocalizedRangeScan::Update and the f64 oracle (``oracle/karto.py``).
    Returns (points [..., B, 2], mask, near); every other beam is at the
    origin."""
    near = near_of(scan)
    mask = scan.valid | near
    r = torch.where(mask, scan.ranges, 0.0)
    pts = torch.stack([r * torch.cos(scan.angles),
                       r * torch.sin(scan.angles)], dim=-1)
    return pts, mask, near


def _stage(pts_store, valid_store, near_store, sid, scan: Scan,
           max_range: float):
    """Polar to cartesian, store write at row ``sid`` (in place; the JAX
    version donates and returns the store) and the barycenter mean.

    The matcher consumes the unfiltered readings (:func:`matcher_points`):
    ``valid_store`` holds their mask and ``near_store`` those below
    range_min, which the map export skips (OccupancyGrid::AddScan).  Only
    the barycenter uses the range-filtered set InRange(range_min,
    threshold) (Karto.h:5361-5427)."""
    pts, valid, near = matcher_points(scan)
    filtered = scan.valid & (scan.ranges <= max_range)
    pts_store[sid] = pts
    valid_store[sid] = valid
    near_store[sid] = near
    mean_local = torch.sum(
        torch.where(filtered[..., None], pts, 0.0), dim=-2
    ) / torch.clamp_min(torch.sum(filtered, dim=-1), 1)[..., None]
    return pts, valid, mean_local


def _fused_seq_step(
    spec: CorrelativeSpec,
    pts_store: torch.Tensor,  # [M, B, 2], written in place at row sid
    valid_store: torch.Tensor,  # [M, B], written in place at row sid
    near_store: torch.Tensor,  # [M, B], written in place at row sid
    sid: int,
    scan: Scan,
    center: torch.Tensor,  # [3] odometry-carried prediction
    chain_idx: torch.Tensor,  # [n] running-chain ids
    chain_poses: torch.Tensor,  # [n, 3]
    max_range: float,
    do_match: bool,
):
    """The per-scan device side of Mapper::Process: the store write and
    barycenter (:func:`_stage`), then the running-chain match
    (Mapper.cpp:2037-2045)."""
    pts, valid, mean_local = _stage(pts_store, valid_store, near_store, sid,
                                    scan, max_range)
    if not do_match:
        return mean_local, None
    res = _gather_match(
        spec, pts_store, valid_store, chain_idx, chain_poses, center, pts,
        valid, penalize=True, refine=True,
    )
    return mean_local, res


def _pack(res, mean_local) -> torch.Tensor:
    """[15] f32: pose 3, response 1, covariance 9, barycenter mean 2 (one
    row of a flush's output, fetched as one block)."""
    return torch.cat([res.pose, res.response[None], res.covariance.reshape(9),
                      mean_local])


def _fused_batch_steps(
    spec: CorrelativeSpec,
    pts_store: torch.Tensor,  # [M, B, 2], written in place
    valid_store: torch.Tensor,  # [M, B], written in place
    near_store: torch.Tensor,  # [M, B], written in place
    poses_store: torch.Tensor,  # [M, 3] matched poses, written in place
    sid0: int,  # state id of the first scan of the flush
    scans: list[Scan],  # K scans
    deltas: torch.Tensor,  # [K, 3] odometry increments
    chains: list[torch.Tensor],  # K running-chain id tensors
    start_pose: torch.Tensor,  # [3] pose of the scan before the flush
    max_range: float,
) -> torch.Tensor:
    """K sequential Mapper::Process device steps issued back to back, with
    no host read: [K, 15] packed outputs (:func:`_pack`).

    Each prediction is ``prev_matched ∘ delta_k`` (the odometry carry,
    Mapper.cpp:2021-2025), prev_matched the previous scan's MATCHED pose:
    within a flush the host's weighted-mean fusion is deferred to the flush
    boundary.  Each match writes its pose into ``poses_store``, from which
    the later scans' chains take theirs."""
    prev = start_pose
    rows = []
    for k, scan in enumerate(scans):
        sid = sid0 + k
        pts, valid, mean_local = _stage(pts_store, valid_store, near_store,
                                        sid, scan, max_range)
        center = se2.compose(prev, deltas[k])
        res = _gather_match(
            spec, pts_store, valid_store, chains[k], poses_store[chains[k]],
            center, pts, valid, penalize=True, refine=True,
        )
        poses_store[sid] = res.pose
        prev = res.pose
        rows.append(_pack(res, mean_local))
    return torch.stack(rows)


def _parallel_steps(
    spec: CorrelativeSpec,
    pts_store: torch.Tensor,  # [M, B, 2], written in place
    valid_store: torch.Tensor,  # [M, B], written in place
    near_store: torch.Tensor,  # [M, B], written in place
    sid0: int,
    scans: list[Scan],  # K scans
    centers: torch.Tensor,  # [K, 3] odometry-chained predictions
    chains: list[torch.Tensor],  # K running-chain id tensors
    chain_poses: list[torch.Tensor],  # K [n_k, 3] chain poses
    max_range: float,
    shards: "_ShardedFlush | None" = None,
) -> torch.Tensor:
    """Throughput mode: every prediction and every in-flush chain pose
    comes from the odometry carry alone (host-computed), so the K matches
    are independent; all K scans are staged, then the K matches issued
    back to back (in blocks over the devices of ``shards``, if given).
    [K, 15] packed outputs."""
    k = len(scans)
    batch = Scan(*(torch.stack(t) for t in zip(
        *(sc._replace(near=near_of(sc)) for sc in scans))))
    _, _, mean_local = _stage(pts_store, valid_store, near_store,
                              slice(sid0, sid0 + k), batch, max_range)
    dev0 = pts_store.device
    blocks = ([(dev0, pts_store, valid_store, 0, k)] if shards is None
              else shards.blocks(k, pts_store, valid_store))
    out = []
    for dev, pts_d, valid_d, lo, hi in blocks:
        with on(dev):
            rows = [
                _pack(_gather_match(
                    spec, pts_d, valid_d, chains[j].to(dev),
                    chain_poses[j].to(dev), centers[j].to(dev),
                    pts_d[sid0 + j], valid_d[sid0 + j], penalize=True,
                    refine=True,
                ), mean_local[j].to(dev))
                for j in range(lo, hi)
            ]
        out.append(torch.stack(rows).to(dev0, non_blocking=True))
    return torch.cat(out)


class _ShardedFlush:
    """:func:`_parallel_steps` with the K matches of a flush split in
    contiguous blocks over ``mesh[axis]``: each block matches on its
    device against that device's copy of the scan stores, taken once a
    flush after the stores are written (none where the device holds the
    stores), and the rows come back in order.  Each match runs whole on
    one device, so the rows are the unsharded flush's bit for bit."""

    def __init__(self, mesh, axis: str):
        self.devices = mesh.axis_devices(axis)
        self.pts = Replicas(self.devices)
        self.valid = Replicas(self.devices)

    def blocks(self, k: int, pts_store, valid_store):
        """(device, its stores, first and end match) a block."""
        pts, valid = self.pts.of(pts_store), self.valid.of(valid_store)
        return [(d, pts[d], valid[d], lo, hi)
                for d, (lo, hi) in zip(self.devices,
                                       split(k, len(self.devices)))]

    def __call__(self, *args) -> torch.Tensor:
        return _parallel_steps(*args, shards=self)


class _Fetch(NamedTuple):
    """Device outputs whose copy to the host has started: ``host`` are
    pinned tensors, complete once ``event`` has passed (None on the CPU,
    where the outputs are the host's already)."""

    host: list[torch.Tensor]
    event: object


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


@dataclasses.dataclass
class _BatchRun:
    """One ``process_batch`` call: its inputs, results and the flushes in
    flight (oldest first)."""

    scans: list
    odom_poses: list
    times: list
    sensor: str
    parallel: bool
    spec: CorrelativeSpec  # the flush spec: expansion off
    results: list
    inflight: list


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
        loop_mesh=None,
        loop_mesh_axis: str = "lattice",
        batch_mesh=None,
        batch_mesh_axis: str = "scan",
        device="cuda",
    ):
        """max_scans: the capacity of the scan store (and so of the pose
        graph).  A graph of any size is solved, each LM step exactly: by a
        dense f64 factor while the graph's padded bucket holds at most
        ``graph.solver.MAX_NODES`` (8192) nodes, by a block-banded one in
        the graph's reverse Cuthill-McKee order past it
        (``graph/solver.py``).

        events: optional ``tpuslam_torch.utils.events.EventBus`` (or any object
        with ``fire(event, **payload)``) — receives the reference's
        MapperListener stream (loop_closure_check, begin/end_loop_closure,
        poses_corrected; Mapper.cpp:2142-2218).

        device: where the scan store lives and every match and solve runs.
        On a CUDA device the patch-sum kernel is first checked once
        against its plain version (``ops.correlative.selfcheck``).

        loop_mesh: optional ``tpuslam_torch.parallel.mesh.Mesh`` whose
        first entry is ``device``: the coarse loop search's angles shard
        over ``loop_mesh[loop_mesh_axis]``
        (``parallel.correlative.make_sharded_match_scan``), bit for bit the
        single-device match.  The sequential matcher and the fine loop
        pass stay on ``device`` (their windows are small).

        batch_mesh: the same, for ``process_batch(parallel=True)``: a
        flush's matches split in blocks over
        ``batch_mesh[batch_mesh_axis]``, each on its device against its
        copy of the scan stores.  A flush whose size the axis does not
        divide runs unsharded."""
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
        # the matcher's mask of each stored beam, and of those the beams
        # below range_min, which the map export skips
        self._valid = torch.zeros((max_scans, b), dtype=torch.bool,
                                  device=self.device)
        self._near = torch.zeros_like(self._valid)
        for mesh in (loop_mesh, batch_mesh):
            if mesh is not None and mesh.first != self._pts.device:
                raise ValueError(f"a mesh's first entry must be the "
                                 f"mapper's device {self._pts.device}, got "
                                 f"{mesh}")
        self._sharded_loop_match = None
        if loop_mesh is not None:
            self._sharded_loop_match = make_sharded_match_scan(
                self.loop_spec, loop_mesh, loop_mesh_axis, penalize=False,
                refine=False,
            )
        self._sharded_parallel_steps = None
        self._batch_mesh_size = 0
        if batch_mesh is not None:
            self._sharded_parallel_steps = _ShardedFlush(batch_mesh,
                                                         batch_mesh_axis)
            self._batch_mesh_size = batch_mesh.shape[batch_mesh_axis]
            for d in batch_mesh.distinct():
                if d.type == "cuda":
                    ops_correlative.selfcheck(str(d))
        # device-resident matched-pose store, refreshed by every sequential
        # flush (carries in-flight poses across pipelined flushes)
        self._poses_dev = None
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
            "expansion_retries": 0,  # batch-mode response-expansion retries
            # every device->host fetch goes through _get
            "fetch_count": 0,
            "fetch_seconds": 0.0,
        }

    @classmethod
    def from_state(cls, cfg: KartoConfig, state: dict, device="cuda"):
        """A mapper that continues from ``state`` (see
        :func:`tpuslam_torch.convert.karto_state_from_numpy`).  Such a
        state holds no reading below range_min (the JAX package drops
        them), so the ``near`` store starts empty."""
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
        long the host waited on the device.  ``tensors`` is a list of
        tensors, or a :class:`_Fetch` whose copy started earlier (then the
        wait is for its event)."""
        t0 = time.perf_counter()
        if isinstance(tensors, _Fetch):
            if tensors.event is not None:
                tensors.event.synchronize()
            out = list(tensors.host)
        else:
            out = [t.cpu() for t in tensors]
        self.stats["fetch_seconds"] += time.perf_counter() - t0
        self.stats["fetch_count"] += 1
        return out

    def _start_fetch(self, tensors) -> _Fetch:
        """Start the copy of ``tensors`` into pinned host memory, followed
        by an event; :meth:`_get` waits on it.  Reads nothing now."""
        if self.device.type != "cuda":
            return _Fetch(list(tensors), None)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _Fetch(host, event)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without blocking the host: staged in
        pinned memory and copied asynchronously (a copy from pageable
        memory waits for the device)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _match_async(
        self, spec, sid: int, center: np.ndarray, chain: list[int],
        penalize: bool, refine: bool,
    ):
        """Queue one chain match; its result stays on the device."""
        idx, poses = self._chain_args(chain)
        center = torch.as_tensor(center, dtype=torch.float32,
                                 device=self.device)
        if (self._sharded_loop_match is not None and spec is self.loop_spec
                and not penalize and not refine):
            # the coarse loop search, its angles sharded over the loop mesh
            wpts, wvalid = _gather_chain(self._pts, self._valid, idx, poses)
            return self._sharded_loop_match(
                center, self._pts[sid], self._valid[sid], wpts, wvalid)
        return _gather_match(
            spec, self._pts, self._valid, idx, poses, center,
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
        scan's frame (spa_solver.cc:81-90), as the reference inverts it.

        The eigenvalues are floored at ``_COV_FLOOR`` only against a
        singular or indefinite covariance (a line-shaped response plateau's
        cross term, rounded in f32).  The matcher's own floors keep every
        variance above it (0.1 res^2 / response, angle_res^2 / norm), so
        no other covariance is touched: a floor at 1e-4, as the JAX package
        takes, caps a fine match's heading precision at 1e4 where the
        reference keeps 2-4e4, and the solve after a closure parts from
        the reference's by up to 0.7 mm."""
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
        prec = (v / np.maximum(w, _COV_FLOOR)) @ v.T
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
            self._near,
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

    def _near_chains(self, sid: int) -> list[list[int]]:
        """LinkNearChains' candidates (Mapper.cpp:965): the near chains of
        sid long enough to match; chains containing sid are invalid."""
        return [c for c in self._find_near_chains(sid)
                if len(c) >= self.cfg.loop_match_minimum_chain_size]

    def _match_near_chains(self, sid: int, chains: list[list[int]]):
        """Each chain's unpenalized match centred on sid's pose: all share
        the centre (fusion applies after them), so they are queued and
        settled with ONE fetch."""
        return self._fetch_matches([
            self._match_async(self.seq_spec, sid, self.poses[sid], c,
                              penalize=False, refine=True)
            for c in chains
        ])

    def _link_near_chains(self, sid, chains, fetched, means, covs) -> None:
        """The near-chain links whose match passes the response gate, then
        the multi-match fusion of ``means``/``covs`` with theirs
        (ComputeWeightedMean, Mapper.cpp:965-972)."""
        for chain, (mean_c, resp_c, cov_c) in zip(chains, fetched):
            if resp_c > self.cfg.link_match_minimum_response_fine - 1e-9:
                means.append(mean_c)
                covs.append(cov_c)
                self._link_chain_to_scan(chain, sid, mean_c, cov_c)
                self.stats["near_chain_links"] += 1
        if means:
            self.poses[sid] = self._weighted_mean(means, covs)
            self.stats["pose_fusions"] += 1

    def _add_running(self, running: list[int], sid: int) -> None:
        """Running window maintenance (AddRunningScan, Mapper.h:1356-1385):
        cap by count, then by the span between the first and last
        barycenters."""
        cfg = self.cfg
        running.append(sid)
        while len(running) > cfg.scan_buffer_size:
            running.pop(0)
        while running and (
            np.sum(
                (self._barycenter(running[0]) - self._barycenter(running[-1]))
                ** 2
            )
            > cfg.scan_buffer_maximum_scan_distance**2
        ):
            running.pop(0)

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

            # near chains, unconditionally (LinkNearChains, Mapper.cpp:965)
            chains = self._near_chains(sid)
            self._link_near_chains(sid, chains,
                                   self._match_near_chains(sid, chains),
                                   means, covs)
            # 5. running window maintenance
            self._add_running(running, sid)

            # 6. loop closure, against every sensor's history
            # (Mapper::Process loops device names, Mapper.cpp:2063-2070)
            if cfg.do_loop_closing:
                for sname in self.sensor_scans:
                    loop_closed |= self._try_close_loop(sid, sname)

        self.last_by_sensor[sensor] = sid
        return ProcessResult(True, self.poses[sid].copy(), response, loop_closed)

    # ------------------------------------------- flush-phased finishing
    # The batch path splits _finish_scan into stage (record + immediate
    # edges + near-chain discovery + window maintenance), one flush-wide
    # LinkNearChains fetch, and settle (link application + fusion + loop
    # closure).  The per-scan :meth:`process` keeps the reference's exact
    # ordering in :meth:`_finish_scan`.

    def _stage_scan(
        self, sid, corrected, response, cov, mean_local, odom_pose, time,
        sensor, running, last_id,
    ) -> dict:
        """Phase A of the flush finish: everything in _finish_scan that
        does not depend on this scan's near-chain match results."""
        cfg = self.cfg
        self.poses[sid] = corrected
        self.mean_locals[sid] = mean_local
        self.records.append(
            _ScanRecord(sid, odom_pose, time, mean_local, sensor)
        )
        self.sensor_scans.setdefault(sensor, []).append(sid)
        means, covs = [], []
        chains: list[list[int]] = []
        if cfg.use_scan_matching:
            # process_batch routes a sensor's first scan through process,
            # so last_id is always set here
            self._add_edge(last_id, sid, corrected, cov)
            means.append(corrected.copy())
            covs.append(cov)
            self._link_chain_to_scan(running, sid, corrected, cov)
            chains = self._near_chains(sid)
            # window maintenance at stage time (before fusion): the span
            # rule sees sid's raw matched barycenter rather than the fused
            # one, a mm-scale input to an eviction threshold
            self._add_running(running, sid)
        self.last_by_sensor[sensor] = sid
        return {
            "sid": sid, "sensor": sensor, "center": self.poses[sid].copy(),
            "means": means, "covs": covs, "chains": chains,
            "response": response,
        }

    def _match_chains_flush(self, staged: list[dict]) -> dict[int, list]:
        """Phase B: every near-chain match of a flush queued on the device,
        then ONE fetch.  Returns {sid: [(pose, response, cov), ...] aligned
        with staged[...]["chains"]}.  These matches use the sequential spec
        as configured: with response expansion on, each reads its coarse
        response once (the reference's semantics)."""
        pairs = [(st, c) for st in staged for c in st["chains"]]
        if not pairs:
            return {}
        ress = [
            self._match_async(self.seq_spec, st["sid"], st["center"], c,
                              penalize=False, refine=True)
            for st, c in pairs
        ]
        out: dict[int, list] = {}
        for (st, _), f in zip(pairs, self._fetch_matches(ress)):
            out.setdefault(st["sid"], []).append(f)
        return out

    def _settle_scan(self, st: dict, fetched: list | None) -> bool:
        """Phase C: near-chain link application + weighted-mean fusion +
        loop closure for one staged scan.

        Chains are re-discovered here: earlier scans of the same flush have
        applied their near-chain link edges by now, and _find_near_chains
        seeds from the distance-gated edge BFS (FindNearLinkedScans,
        Mapper.cpp:1290-1305), so the stage-time chain set is thinner.  A
        re-discovered chain equal to a staged one reuses the flush's match
        (its centre only moved by same-flush fusion); new or changed chains
        match now.  ``fetched=None`` re-matches every chain: used after an
        earlier loop closure of the flush corrected the poses the flush's
        matches were centred on (per-scan semantics for the rest of the
        flush)."""
        cfg = self.cfg
        sid = st["sid"]
        chains = self._near_chains(sid)
        if fetched is None:
            fetched = self._match_near_chains(sid, chains)
        else:
            by_chain = {tuple(c): f for c, f in zip(st["chains"], fetched)}
            miss = [c for c in chains if tuple(c) not in by_chain]
            by_chain.update(zip(map(tuple, miss),
                                self._match_near_chains(sid, miss)))
            fetched = [by_chain[tuple(c)] for c in chains]
        self._link_near_chains(sid, chains, fetched, st["means"], st["covs"])
        loop_closed = False
        if cfg.use_scan_matching and cfg.do_loop_closing:
            for sname in self.sensor_scans:
                loop_closed |= self._try_close_loop(sid, sname)
        return loop_closed

    # --------------------------------------------------------- batch process
    def _dispatch_flush(self, run: "_BatchRun", pend: list[int]) -> dict:
        """Build a flush's inputs on the host and issue its device program,
        with no host read: the inputs go up through pinned memory, the
        outputs start their copy down (:meth:`_start_fetch`)."""
        cfg = self.cfg
        k = len(pend)
        inflight = run.inflight
        # sids continue past the in-flight flushes (records not yet added)
        sid0 = self._num() + sum(len(r["pending"]) for r in inflight)
        cap = cfg.scan_buffer_size
        running = self.running_by_sensor.setdefault(run.sensor, [])
        if inflight:
            prev_odom = inflight[-1]["odom_last"]
        else:
            prev_odom = self.records[self.last_by_sensor[run.sensor]].odom_pose
        deltas = np.zeros((k, 3), np.float32)
        for j, i in enumerate(pend):
            deltas[j] = _np_relative(prev_odom, run.odom_poses[i])
            prev_odom = run.odom_poses[i]

        # odometry-chained predictions of this flush's poses: they stand in
        # for the matches not yet on the host in the span rule below, and
        # for this flush in the next dispatch while it is in flight
        if inflight:
            prev_pose = inflight[-1]["pred_poses"][-1]
            pred_prior = {}
            for r in inflight:
                pred_prior.update(zip(r["sids"], r["pred_poses"]))
        else:
            prev_pose = np.asarray(
                self.poses[self.last_by_sensor[run.sensor]], np.float64
            )
            pred_prior = {}
        pred_poses = []
        for j in range(k):
            prev_pose = _np_compose(prev_pose, deltas[j])
            pred_poses.append(prev_pose.copy())

        def _pos(s: int) -> np.ndarray:
            """Barycenter of scan s: exact for finished scans, the
            predicted sensor position for in-flight and in-flush ones."""
            if s in pred_prior:
                return pred_prior[s][:2]
            if s >= sid0:
                return pred_poses[s - sid0][:2]
            return self._barycenter(s)

        # the running window (AddRunningScan, Mapper.h:1356-1385) each
        # scan of the flush matches against: count cap and span rule, the
        # span on predicted positions for scans not yet finished
        max_span2 = cfg.scan_buffer_maximum_scan_distance**2

        def _sim_add(sim: list[int], sid: int) -> None:
            sim.append(sid)
            while len(sim) > cap:
                sim.pop(0)
            while sim and float(
                np.sum((_pos(sim[0]) - _pos(sim[-1])) ** 2)
            ) > max_span2:
                sim.pop(0)

        sim = list(running)
        for r in inflight:
            for s in r["sids"]:
                _sim_add(sim, s)
        chains = []
        for j in range(k):
            chains.append(list(sim))
            _sim_add(sim, sid0 + j)
        offs = np.cumsum([0] + [len(c) for c in chains])
        flat_ids = np.asarray(sum(chains, []), np.int64)
        ids = self._upload(flat_ids)
        chain_dev = [ids[offs[j]:offs[j + 1]] for j in range(k)]
        scans = [run.scans[i].to(self.device) for i in pend]
        if run.parallel:
            centers = np.asarray(pred_poses, np.float32)
            lookup = self.poses[: self.max_scans].astype(np.float32)
            lookup[sid0: sid0 + k] = centers
            f32 = self._upload(np.concatenate(
                [centers.reshape(-1), lookup[flat_ids].reshape(-1)]))
            cposes = f32[3 * k:].view(-1, 3)
            steps = _parallel_steps
            if (self._sharded_parallel_steps is not None
                    and k % self._batch_mesh_size == 0):
                steps = self._sharded_parallel_steps
            out = steps(
                run.spec, self._pts, self._valid, self._near, sid0, scans,
                f32[: 3 * k].view(k, 3), chain_dev,
                [cposes[offs[j]:offs[j + 1]] for j in range(k)],
                cfg.use_scan_range,
            )
        else:
            m = self.max_scans
            f32 = self._upload(np.concatenate([
                self.poses[:m].astype(np.float32).reshape(-1),
                deltas.reshape(-1),
            ]))
            poses_in = f32[: 3 * m].view(m, 3)
            if inflight:
                # the host poses lack the in-flight flushes' matches: take
                # them from the device pose store (it holds every earlier
                # flush's), and chain from the last of them
                i = torch.arange(m, device=self.device)[:, None]
                lo = inflight[0]["sid0"]
                poses_in = torch.where((i >= lo) & (i < sid0),
                                       self._poses_dev, poses_in)
                start_pose = poses_in[sid0 - 1]
            else:
                start_pose = poses_in[self.last_by_sensor[run.sensor]]
            self._poses_dev = poses_in
            out = _fused_batch_steps(
                run.spec, self._pts, self._valid, self._near, poses_in,
                sid0, scans,
                f32[3 * m:].view(k, 3), chain_dev, start_pose,
                cfg.use_scan_range,
            )
        return {
            "pending": list(pend),
            "sids": [sid0 + j for j in range(k)],
            "sid0": sid0,
            "odom_last": run.odom_poses[pend[-1]],
            "pred_poses": pred_poses,
            "deltas": deltas,
            "chains": chains,
            "running": running,
            "fetch": self._start_fetch([out]),
        }

    def _finish_flush(self, run: "_BatchRun", rec: dict) -> None:
        """Fetch a dispatched flush and settle it on the host: the
        expansion retry, stage, the flush's near-chain matches, settle."""
        (out,) = self._get(rec["fetch"])
        out = out.numpy()
        sid0 = rec["sid0"]
        last_id = self.last_by_sensor[run.sensor]
        staged: list[tuple[int, dict]] = []
        for j, i in enumerate(rec["pending"]):
            sid = sid0 + j
            lid_j = last_id if j == 0 else sid - 1
            pose_j = np.asarray(out[j, :3], np.float64)
            resp_j = float(out[j, 3])
            cov_j = np.asarray(out[j, 4:13], np.float64).reshape(3, 3)
            if resp_j == 0.0 and self.seq_spec.use_response_expansion:
                # the host-side response-expansion retry (Mapper.cpp:
                # 242-272): the flush ran without expansion
                center_j = _np_compose(self.poses[lid_j], rec["deltas"][j])
                pose_j, resp_j, cov_j = self._match(
                    self.seq_spec, sid, center_j, rec["chains"][j],
                    penalize=True, refine=True,
                )
                self.stats["expansion_retries"] += 1
            staged.append((i, self._stage_scan(
                sid, pose_j, resp_j, cov_j, out[j, 13:15].copy(),
                run.odom_poses[i], run.times[i], run.sensor, rec["running"],
                lid_j,
            )))
        fetched = self._match_chains_flush([st for _, st in staged])
        closed_in_flush = False
        for i, st in staged:
            # a loop closure earlier in this flush corrected the poses the
            # flush's matches were centred on: re-match the rest per scan
            lc = self._settle_scan(
                st, None if closed_in_flush else fetched.get(st["sid"], [])
            )
            closed_in_flush |= lc
            run.results[i] = ProcessResult(
                True, self.poses[st["sid"]].copy(), st["response"], lc
            )

    def process_batch(
        self,
        scans: list[Scan],
        odom_poses,
        times=None,
        sensor: str = "laser0",
        batch_size: int = 16,
        parallel: bool = False,
        pipeline: bool | int = False,
    ) -> list[ProcessResult]:
        """Offline (bag-playback) processing: the device side of up to
        ``batch_size`` consecutive scans is issued back to back with no
        host read (:func:`_fused_batch_steps`), and the host settles the
        flush after one fetch.

        Semantics against scan-by-scan :meth:`process` (deltas bounded by
        one flush, as in the JAX package):
        - within a flush, the running chain a scan matches against applies
          the count cap and the span rule (Mapper.h:1356-1385), the span
          decided on odometry-predicted positions for scans whose matches
          are not on the host yet; chain poses are the raw matched poses
          (fusion and loop-closure corrections apply on the host after the
          flush and take effect from the next one);
        - gating (HasMovedEnough) is odometry/time-only, as the
          reference's (Mapper.cpp:2087-2120), and exact per scan;
        - response expansion (Mapper.cpp:242-272) is a host-side retry
          after the flush: the flush runs without it, and a scan whose
          coarse response comes back exactly 0 is matched again alone with
          expansion on (``stats["expansion_retries"]`` counts these; the
          flush's later predictions keep the pre-retry pose).

        ``parallel=True``: the K matches of a flush take odometry-chained
        centres and chain poses, so they are independent; they are issued
        back to back with one fetch.  Valid while odometric drift over one
        flush stays well inside the search window.

        ``pipeline=True`` keeps one flush in flight, ``pipeline=N`` (an int
        >= 2) N-1: a flush is dispatched before the previous one is
        fetched, each dispatched flush's outputs start their copy to pinned
        host memory at once, and the host settles a flush while the
        device runs the next.  The next flush's chain poses for in-flight
        scans come from the device pose store; host corrections land up to
        N-1 flushes later.  Sequential mode only."""
        cfg = self.cfg
        n_in = len(scans)
        odom_poses = [np.asarray(p, np.float64) for p in odom_poses]
        times = (
            [float(t) for t in times] if times is not None else [0.0] * n_in
        )
        depth = 2 if pipeline is True else int(pipeline or 0)
        if pipeline is not False and pipeline is not True and depth < 2:
            raise ValueError("pipeline must be False, True, or an int >= 2")
        if pipeline and parallel:
            raise ValueError(
                "pipeline=True requires sequential mode (parallel=False): "
                "the parallel flush does not carry the device pose store"
            )
        run = _BatchRun(
            scans=scans, odom_poses=odom_poses, times=times, sensor=sensor,
            parallel=parallel,
            # expansion runs as a host retry (see above)
            spec=dataclasses.replace(self.seq_spec,
                                     use_response_expansion=False),
            results=[None] * n_in, inflight=[],
        )
        pending: list[int] = []  # input indices accepted, awaiting flush
        # the last accepted scan (may still be pending)
        last_odom = last_time = None
        if (lid := self.last_by_sensor.get(sensor)) is not None:
            last_odom = self.records[lid].odom_pose
            last_time = self.records[lid].time

        def flush(final: bool = False):
            if pending:
                run.inflight.append(self._dispatch_flush(run, pending))
                pending.clear()
            keep = 0 if final else max(depth - 1, 0)
            while len(run.inflight) > keep:
                self._finish_flush(run, run.inflight.pop(0))

        for i in range(n_in):
            n_inflight = sum(len(r["pending"]) for r in run.inflight)
            if self._num() + n_inflight + len(pending) >= self.max_scans:
                run.results[i] = ProcessResult(False, odom_poses[i], 0.0,
                                               False)
                continue
            if self.last_by_sensor.get(sensor) is None and not pending:
                # first scan of the sensor: the per-scan path (cross-sensor
                # links, no matching)
                run.results[i] = self.process(scans[i], odom_poses[i],
                                              times[i], sensor)
                if run.results[i].processed:
                    last_odom = odom_poses[i]
                    last_time = times[i]
                continue
            # HasMovedEnough against the last ACCEPTED scan (odom/time only)
            dt = times[i] - last_time
            dh = abs(
                math.atan2(
                    math.sin(odom_poses[i][2] - last_odom[2]),
                    math.cos(odom_poses[i][2] - last_odom[2]),
                )
            )
            d2 = float(np.sum((odom_poses[i][:2] - last_odom[:2]) ** 2))
            if not (
                dt >= cfg.minimum_time_interval
                or dh >= cfg.minimum_travel_heading
                or d2 >= cfg.minimum_travel_distance**2 - 1e-9
            ):
                # the report's prediction carries the last FINISHED
                # correction (Mapper.cpp:2021-2025)
                lid = self.last_by_sensor[sensor]
                pred = _np_compose(
                    _np_compose(
                        self.poses[lid],
                        _np_inverse(self.records[lid].odom_pose),
                    ),
                    odom_poses[i],
                )
                run.results[i] = ProcessResult(False, pred, 0.0, False)
                continue
            if not cfg.use_scan_matching:
                flush(final=True)
                run.results[i] = self.process(scans[i], odom_poses[i],
                                              times[i], sensor)
                last_odom = odom_poses[i]
                last_time = times[i]
                continue
            pending.append(i)
            last_odom = odom_poses[i]
            last_time = times[i]
            if len(pending) >= batch_size:
                flush()
        flush(final=True)
        return run.results


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
        self.poses[:n] = poses[:n].cpu().numpy().astype(np.float64)
        if self.events is not None:
            self.events.fire(
                "poses_corrected",
                nodes=n,
                edges=len(self.edges),
                initial_cost=float(stats.initial_cost),
                final_cost=float(stats.final_cost),
            )

    # --------------------------------------------------------------- output
    def occupancy_grid(self, resolution: float | None = None):
        """OccupancyGrid::CreateFromScans (Karto.h:5659-5990): the pass/hit
        counts of every scan at its corrected pose, thresholded; returns
        (GridSpec, int8 [H, W] on the mapper's device), or None with no
        scans.

        Over-threshold beams (range >= use_scan_range) are kept: ``AddScan``
        (Karto.h:5852-5899) clips each one's endpoint to the threshold ray
        point and traces it free-only (``isEndPointValid = range <
        threshold - KT_TOLERANCE``).  The store holds those beams' true
        endpoints (staging only masks ``_valid``), so the raw range comes
        back as ``|pts|``.  The grid's origin and size are bucketed to 64
        cells as the JAX package buckets them, so two maps compare cell for
        cell.  Scans are traced a chunk at a time, their counts added as
        int32; the f32 arithmetic is written as the jitted JAX package
        computes it (its FMAs in ``|pts|`` and the pose transform, glibc's
        cosf/sinf of the headings), so the map is the JAX package's bit for
        bit on the CPU."""
        cfg = self.cfg
        res = resolution or cfg.resolution
        n = self._num()
        if n == 0:
            return None
        poses = self.poses[:n]
        margin = cfg.use_scan_range + 1.0
        xmin = poses[:, 0].min() - margin
        xmax = poses[:, 0].max() + margin
        ymin = poses[:, 1].min() - margin
        ymax = poses[:, 1].max() + margin

        def _bucket(c, m=64):
            return m * int(math.ceil(c / m))

        cell64 = 64 * res
        xmin = math.floor(xmin / cell64) * cell64
        ymin = math.floor(ymin / cell64) * cell64
        spec = GridSpec(
            res,
            _bucket(int(math.ceil((xmax - xmin) / res))),
            _bucket(int(math.ceil((ymax - ymin) / res))),
            xmin,
            ymin,
        )
        thr = cfg.use_scan_range
        max_steps = int(thr / res) + 2
        p32 = poses.astype(np.float32)
        pose_dev = self._upload(
            np.concatenate([p32[:, :2], _cos_sin_f32(p32[:, 2])], 1))
        counts = zero_counts(spec, self.device)
        per = max(1, _MAP_CHUNK // (self._pts.shape[1] * max_steps))
        for a in range(0, n, per):
            b = min(n, a + per)
            pts = self._pts[a:b]
            valid = self._valid[a:b] & ~self._near[a:b]
            pp = pose_dev[a:b, None, :]  # [k, 1, 4]
            r, world = _clipped_endpoints(pts, pp, thr)
            counts = accumulate_scan(
                spec, counts, spec.world_to_map(pp[..., :2]),
                spec.world_to_map(world), r >= (thr - 1e-6), valid,
                max_steps=max_steps, trace_includes_endpoint=True,
            )
        return spec, karto_export(
            counts,
            min_pass_through=cfg.min_pass_through,
            occupancy_threshold=cfg.occupancy_threshold,
        )
