"""SLAM-state checkpoint/resume (counterpart of ``tpuslam/checkpoint.py``).

The reference has NO checkpointing (SURVEY.md §5); the JAX package saves
engine states as npz with a structure manifest, and this module writes and
reads the same files, so a checkpoint from either package loads in the
other:

- ``save_pytree`` / ``load_pytree``: a state of NamedTuples, tuples,
  lists and dicts with tensor (or NumPy, or Python scalar) leaves, as
  ``leaf_<i>`` arrays in JAX's flattening order (fields in order, dict
  keys sorted, ``None`` holds no leaf) plus ``__keypaths__``, each leaf's
  path written as ``jax.tree_util.keystr`` writes it (``.pose``,
  ``.log_odds[0]``, ``['a']``);
- ``save_karto`` / ``load_karto``: a ``KartoMapper``'s scans, poses,
  records, edges and windows.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> list[tuple[str, object]]:
    """(key path, leaf) pairs in jax.tree_util's order."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(value: np.ndarray, leaf):
    """``value`` as the kind of ``leaf``: a tensor of its dtype on its
    device, a NumPy array of its dtype, or a Python scalar of its type."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(value, device=leaf.device).to(leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return np.asarray(value, leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(value.item())
    return value


def save_pytree(path: str | os.PathLike, tree) -> None:
    """Save a state (NamedTuples, tuples, lists, dicts of tensors) to one
    npz in the JAX package's layout."""
    flat = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in
              enumerate(flat)}
    arrays["__keypaths__"] = np.frombuffer(
        json.dumps([k for k, _ in flat]).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_pytree(path: str | os.PathLike, like):
    """Load a state saved by ``save_pytree`` (of either package); ``like``
    gives the structure, and each leaf's dtype and device.

    The stored key paths must equal ``like``'s: a same-leaf-count but
    differently-structured template is rejected instead of silently
    reinterpreting the leaves.  A checkpoint without key paths (the JAX
    package's legacy ``__treedef__`` manifest, which only that JAX
    version can read) is rejected too."""
    z = np.load(path)
    flat = _flatten(like)
    n = len([k for k in z.files if k.startswith("leaf_")])
    if n != len(flat):
        raise ValueError(
            f"checkpoint has {n} leaves; template expects {len(flat)}"
        )
    if "__keypaths__" not in z.files:
        raise ValueError(
            "checkpoint structure manifest missing: no __keypaths__ (a "
            "legacy __treedef__ manifest cannot be verified here)"
        )
    stored = json.loads(bytes(z["__keypaths__"]).decode())
    mine = [k for k, _ in flat]
    if stored != mine:
        diff = next(
            (i for i, (a, b) in enumerate(zip(stored, mine)) if a != b),
            min(len(stored), len(mine)),
        )
        raise ValueError(
            "checkpoint structure manifest does not match the template "
            f"pytree (first difference at leaf {diff}: "
            f"stored={stored[diff] if diff < len(stored) else '<none>'} "
            f"template={mine[diff] if diff < len(mine) else '<none>'})"
        )
    leaves = iter([_like(z[f"leaf_{i}"], leaf)
                   for i, (_, leaf) in enumerate(flat)])
    return _unflatten(like, leaves)


def save_karto(path: str | os.PathLike, mapper) -> None:
    """Checkpoint a ``models.karto.KartoMapper`` (scans, poses, edges,
    windows) in the JAX package's npz layout."""
    n = len(mapper.records)
    e = len(mapper.edges)
    meta = {
        "sensors": [r.sensor for r in mapper.records],
        "sensor_scans": dict(mapper.sensor_scans),
        "running_by_sensor": dict(mapper.running_by_sensor),
        "last_by_sensor": {k: int(v) for k, v in mapper.last_by_sensor.items()},
    }
    np.savez_compressed(
        path,
        pts=_to_numpy(mapper._pts[:n]),
        # the JAX package's mask (readings in range), and apart from it
        # the readings below range_min that the port's matcher also takes
        valid=_to_numpy(mapper._valid[:n] & ~mapper._near[:n]),
        near=_to_numpy(mapper._near[:n]),
        poses=mapper.poses[:n],
        odom=np.stack([r.odom_pose for r in mapper.records])
        if n
        else np.zeros((0, 3)),
        times=np.array([r.time for r in mapper.records]),
        mean_local=np.stack([r.mean_local for r in mapper.records])
        if n
        else np.zeros((0, 2)),
        edge_i=np.array([x[0] for x in mapper.edges], np.int32),
        edge_j=np.array([x[1] for x in mapper.edges], np.int32),
        edge_meas=np.stack([x[2] for x in mapper.edges])
        if e
        else np.zeros((0, 3)),
        edge_prec=np.stack([x[3] for x in mapper.edges])
        if e
        else np.zeros((0, 3, 3)),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def load_karto(path: str | os.PathLike, mapper) -> None:
    """Restore a KartoMapper checkpoint (of either package) into a
    freshly-constructed mapper (same config and num_beams)."""
    from tpuslam_torch.models.karto import _ScanRecord

    z = np.load(path)
    n = z["poses"].shape[0]
    if n > mapper.max_scans:
        raise ValueError("checkpoint larger than mapper capacity")
    meta = json.loads(bytes(z["meta"]).decode())
    mapper._pts[:n] = torch.as_tensor(z["pts"], device=mapper.device)
    valid = torch.as_tensor(z["valid"], device=mapper.device)
    near = (torch.as_tensor(z["near"], device=mapper.device)
            if "near" in z.files else torch.zeros_like(valid))
    mapper._valid[:n] = valid | near
    mapper._near[:n] = near
    mapper.poses[:n] = z["poses"]
    mapper.mean_locals[:n] = z["mean_local"]
    mapper.records = [
        _ScanRecord(i, z["odom"][i], float(z["times"][i]), z["mean_local"][i],
                    meta["sensors"][i])
        for i in range(n)
    ]
    mapper.sensor_scans = {
        k: [int(x) for x in v] for k, v in meta["sensor_scans"].items()
    }
    mapper.running_by_sensor = {
        k: [int(x) for x in v] for k, v in meta["running_by_sensor"].items()
    }
    mapper.last_by_sensor = {
        k: int(v) for k, v in meta["last_by_sensor"].items()
    }
    mapper.edges = [
        (int(z["edge_i"][k]), int(z["edge_j"][k]), z["edge_meas"][k],
         z["edge_prec"][k])
        for k in range(z["edge_i"].shape[0])
    ]
    mapper.adj = {}
    mapper._edge_keys = {(i, j) for i, j, _, _ in mapper.edges}
    for i, j, _, _ in mapper.edges:
        mapper.adj.setdefault(i, set()).add(j)
        mapper.adj.setdefault(j, set()).add(i)
