"""Carry a running engine's state across from the JAX package.

This system has no weights; what a running engine has learned is its
state.  Each function here takes that state as NumPy arrays and plain
Python containers (the JAX state after ``np.asarray``) and returns the
port's checked copy:

- :func:`karto_state_from_numpy`: a Karto mapper's scan store, poses,
  graph and windows, as a dict ``KartoMapper.from_state(cfg, state,
  device)`` continues from;
- :func:`odom_state_from_numpy`: a PL-ICP odometry ``OdomState``;
- :func:`frame_state_from_numpy`: a frame-to-frame ``FrameState`` (ICP or
  PL-ICP);
- :func:`hector_state_from_numpy`: a Hector ``HectorState`` (the log-odds
  pyramid, pose, last update pose and update count);
- :func:`pose_graph_from_numpy`: a padded ``PoseGraph`` with its masks,
  as the port's solver takes it.

Nothing here sees jax: the caller does the JAX -> NumPy dump.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.graph import backends, solver
from tpuslam_torch.models import hector_slam, plicp_odometry, scan_match_icp

STATE_KEYS = (
    "_pts", "_valid", "poses", "mean_locals", "records", "edges",
    "_edge_keys", "adj", "sensor_scans", "running_by_sensor",
    "last_by_sensor", "stats",
)
_RECORD_KEYS = ("state_id", "odom_pose", "time", "mean_local", "sensor")


def _record(r) -> dict:
    d = dataclasses.asdict(r) if dataclasses.is_dataclass(r) else dict(r)
    if set(d) != set(_RECORD_KEYS):
        raise ValueError(f"scan record keys {sorted(d)} != {_RECORD_KEYS}")
    return {
        "state_id": int(d["state_id"]),
        "odom_pose": np.asarray(d["odom_pose"], np.float64).copy(),
        "time": float(d["time"]),
        "mean_local": np.asarray(d["mean_local"], np.float64).copy(),
        "sensor": str(d["sensor"]),
    }


def karto_state_from_numpy(d: dict) -> dict:
    """Validate and copy a Karto mapper state given as NumPy/Python values.

    Keys: ``STATE_KEYS``.  ``_pts`` [M, B, 2] and ``_valid`` [M, B] are the
    scan store, ``poses`` [M, 3] and ``mean_locals`` [M, 2] the host
    arrays (float64), ``records`` the per-scan records (dataclasses or
    dicts), ``edges`` (i, j, measurement [3], precision [3, 3]) tuples."""
    missing = set(STATE_KEYS) - set(d)
    if missing:
        raise KeyError(f"missing Karto state keys {sorted(missing)}")
    pts = np.asarray(d["_pts"], np.float32)
    valid = np.asarray(d["_valid"], bool)
    poses = np.asarray(d["poses"], np.float64)
    means = np.asarray(d["mean_locals"], np.float64)
    m = poses.shape[0]
    if pts.ndim != 3 or pts.shape[0] != m or pts.shape[2] != 2:
        raise ValueError(f"_pts must be [{m}, B, 2], got {pts.shape}")
    if valid.shape != pts.shape[:2]:
        raise ValueError(f"_valid must be {pts.shape[:2]}, got {valid.shape}")
    if poses.shape != (m, 3) or means.shape != (m, 2):
        raise ValueError(
            f"poses/mean_locals must be [{m}, 3]/[{m}, 2], got "
            f"{poses.shape}/{means.shape}"
        )
    records = [_record(r) for r in d["records"]]
    if [r["state_id"] for r in records] != list(range(len(records))):
        raise ValueError("records must hold state ids 0..n-1 in order")
    if len(records) > m:
        raise ValueError(f"{len(records)} records exceed capacity {m}")
    edges = [
        (
            int(i), int(j),
            np.asarray(meas, np.float64).reshape(3).copy(),
            np.asarray(prec, np.float64).reshape(3, 3).copy(),
        )
        for i, j, meas, prec in d["edges"]
    ]
    return {
        "_pts": pts.copy(),
        "_valid": valid.copy(),
        "poses": poses.copy(),
        "mean_locals": means.copy(),
        "records": records,
        "edges": edges,
        "_edge_keys": {(int(i), int(j)) for i, j in d["_edge_keys"]},
        "adj": {int(k): {int(x) for x in v} for k, v in d["adj"].items()},
        "sensor_scans": {
            str(k): [int(x) for x in v] for k, v in d["sensor_scans"].items()
        },
        "running_by_sensor": {
            str(k): [int(x) for x in v]
            for k, v in d["running_by_sensor"].items()
        },
        "last_by_sensor": {
            str(k): int(v) for k, v in d["last_by_sensor"].items()
        },
        "stats": dict(d["stats"]),
    }


def _fields(state, keys) -> dict:
    d = state._asdict() if hasattr(state, "_asdict") else dict(state)
    if set(d) != set(keys):
        raise ValueError(f"state keys {sorted(d)} != {sorted(keys)}")
    return d


def _points(pts, valid, what: str):
    pts = np.asarray(pts, np.float32)
    valid = np.asarray(valid, bool)
    if pts.ndim != 2 or pts.shape[1] != 2 or valid.shape != pts.shape[:1]:
        raise ValueError(f"{what} must be [B, 2] / [B], got {pts.shape} / "
                         f"{valid.shape}")
    return pts, valid


def _pose(d: dict, k: str, device) -> torch.Tensor:
    a = np.asarray(d[k], np.float32)
    if a.shape != (3,):
        raise ValueError(f"{k} must be [3], got {a.shape}")
    return torch.tensor(a, device=device)


def odom_state_from_numpy(state, device="cuda") -> plicp_odometry.OdomState:
    """A JAX ``plicp_odometry.OdomState`` (as NumPy values) on ``device``."""
    d = _fields(state, plicp_odometry.OdomState._fields)
    pts, valid = _points(d["keyframe_pts"], d["keyframe_valid"], "keyframe")

    return plicp_odometry.OdomState(
        keyframe_pts=torch.tensor(pts, device=device),
        keyframe_valid=torch.tensor(valid, device=device),
        keyframe_pose=_pose(d, "keyframe_pose", device),
        base_in_odom=_pose(d, "base_in_odom", device),
        velocity=_pose(d, "velocity", device),
        scans_since_keyframe=torch.tensor(
            int(d["scans_since_keyframe"]), dtype=torch.int32, device=device),
        initialized=bool(d["initialized"]),
    )


def hector_state_from_numpy(state, cfg, device="cuda"
                            ) -> hector_slam.HectorState:
    """A JAX ``HectorState`` (as NumPy values) on ``device``; the log-odds
    levels are checked against ``make_specs(cfg)``."""
    d = _fields(state, hector_slam.HectorState._fields)
    specs = hector_slam.make_specs(cfg)
    levels = [np.asarray(lo, np.float32) for lo in d["log_odds"]]
    want = [s.shape for s in specs]
    if [lo.shape for lo in levels] != want:
        raise ValueError(f"log_odds levels {[lo.shape for lo in levels]} != "
                         f"the config's {want}")

    return hector_slam.HectorState(
        log_odds=tuple(torch.tensor(lo, device=device) for lo in levels),
        pose=_pose(d, "pose", device),
        last_update_pose=_pose(d, "last_update_pose", device),
        num_updates=torch.tensor(int(d["num_updates"]), dtype=torch.int32,
                                 device=device),
    )


def frame_state_from_numpy(state, device="cuda") -> scan_match_icp.FrameState:
    """A JAX ``FrameState`` of ``scan_match_icp`` or ``scan_match_plicp``
    (as NumPy values) on ``device``; the port's two models share it."""
    d = _fields(state, scan_match_icp.FrameState._fields)
    pts, valid = _points(d["last_pts"], d["last_valid"], "last scan")
    return scan_match_icp.FrameState(
        last_pts=torch.tensor(pts, device=device),
        last_valid=torch.tensor(valid, device=device),
        initialized=bool(d["initialized"]),
    )


# the JAX package's PoseGraph: padded arrays and their masks
POSE_GRAPH_KEYS = ("poses", "node_mask", "edge_i", "edge_j", "measurements",
                   "precisions", "edge_mask")


def pose_graph_from_numpy(graph, device="cuda") -> solver.PoseGraph:
    """A JAX ``PoseGraph`` (as NumPy values: ``poses`` [N, 3],
    ``node_mask`` [N], ``edge_i``/``edge_j`` [E], ``measurements`` [E, 3],
    ``precisions`` [E, 3, 3], ``edge_mask`` [E]) as the port's float64
    graph on ``device``, of the same N nodes and E edges, with the
    solver's index built from its live edges
    (``backends.index_from_edges``).  The masked nodes stay fixed in the
    solve, as in the JAX package's."""
    d = _fields(graph, POSE_GRAPH_KEYS)
    poses = np.array(d["poses"], np.float64)  # a copy: the tensor shares it
    node_mask = np.array(d["node_mask"], bool)
    edge_i = np.array(d["edge_i"], np.int64)
    edge_j = np.array(d["edge_j"], np.int64)
    meas = np.array(d["measurements"], np.float64)
    prec = np.array(d["precisions"], np.float64)
    edge_mask = np.array(d["edge_mask"], bool)
    n, e = len(poses), len(edge_i)
    if poses.shape != (n, 3) or node_mask.shape != (n,):
        raise ValueError(f"poses / node_mask must be [N, 3] / [N], got "
                         f"{poses.shape} / {node_mask.shape}")
    if (edge_j.shape, meas.shape, prec.shape, edge_mask.shape) != (
            (e,), (e, 3), (e, 3, 3), (e,)):
        raise ValueError(
            f"edge_i / edge_j / measurements / precisions / edge_mask must "
            f"be [E] / [E] / [E, 3] / [E, 3, 3] / [E], got {edge_i.shape} / "
            f"{edge_j.shape} / {meas.shape} / {prec.shape} / "
            f"{edge_mask.shape}")
    index = backends.index_from_edges(n, edge_i, edge_j, edge_mask, device)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return solver.mark_indexed(solver.PoseGraph(
        poses=dev(poses), node_mask=dev(node_mask), edge_i=dev(edge_i),
        edge_j=dev(edge_j), measurements=dev(meas), precisions=dev(prec),
        edge_mask=dev(edge_mask), **index))
