"""Carry a Karto mapper's state across from the JAX package.

This system has no weights; what a running mapper has learned is its
state: the device scan store, the corrected poses, the graph and the
windows.  :func:`karto_state_from_numpy` takes that state as NumPy arrays
and plain Python containers (a JAX mapper's attributes after
``np.asarray``) and returns a checked, copied dict that
``KartoMapper.from_state(cfg, state, device)`` continues from.  Nothing
here sees jax: the caller does the JAX -> NumPy dump.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
