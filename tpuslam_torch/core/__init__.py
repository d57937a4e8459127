"""Core containers and algebra: the names ``tpuslam/core/__init__.py``
re-exports, under the same names.

They load on first access (a module ``__getattr__``), not when the package
does: ``tpuslam_torch.core.config`` imports neither torch nor numpy, and a
process that only reads configs (``import tpuslam_torch.core.config``
passes through this file) should not pay for ``grid`` and ``scan``.
"""

from __future__ import annotations

import importlib

_MODULES = ("config", "frames", "grid", "scan", "se2")
_NAMES = {
    "FrameTree": "frames",
    "LaserRegistry": "frames",
    "Transform3": "frames",
    "GridSpec": "grid",
    "Scan": "scan",
    "make_scan": "scan",
    "scan_to_points": "scan",
}

# the reference's order: the modules, then the names
__all__ = [*_MODULES, *sorted(_NAMES)]


def __getattr__(name: str):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _NAMES:
        value = getattr(importlib.import_module(
            f"{__name__}.{_NAMES[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

