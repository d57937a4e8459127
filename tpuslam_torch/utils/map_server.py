"""Periodic map publishing: the reference's map-republish loops, event-native;
a copy of ``tpuslam/utils/map_server.py`` (NumPy only).

The reference serves maps two ways:
- karto: ``updateMap`` re-exports ``OccupancyGrid::CreateFromScans`` when a
  scan arrives more than ``map_update_interval`` (default 5 s) after the
  last export (lesson6/src/karto_slam.cc:94-96, 313-325, 507-581);
- hector: a dedicated publish thread re-exports every level's grid each
  ``map_pub_period`` (default 2 s) under a per-level mutex
  (lesson4/src/hector_mapping/hector_slam.cc:86, 136, 253-317).

tpuslam has no topic bus and no mutexes (state is functional); the analog
is a :class:`MapPublisher` the driving loop calls with each scan's
timestamp.  When the period elapses it pulls a fresh occupancy image from
the engine and fires a ``map_update`` event carrying the image, its
metadata, and a delta summary against the previous publish (changed-cell
count + bounding box) so downstream consumers (web viewers, bag writers)
can stream increments instead of full frames.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from tpuslam_torch.utils.events import EventBus

Exporter = Callable[[], np.ndarray]  # -> int8-ish occupancy image [H, W]


class MapPublisher:
    """Call :meth:`maybe_publish` after every processed scan.

    exporter: zero-arg callable returning the current occupancy image
    (e.g. ``lambda: mapper.occupancy_grid()[1]`` — element 0 is the
    GridSpec — or a hector grid export).
    Timestamps are the caller's scan clock (bag time), matching the
    reference's use of scan-header stamps, karto_slam.cc:313-316."""

    def __init__(
        self,
        bus: EventBus,
        exporter: Exporter,
        period: float = 5.0,
        event: str = "map_update",
    ) -> None:
        self.bus = bus
        self.exporter = exporter
        self.period = float(period)
        self.event = event
        self._last_time: float | None = None
        self._last_img: np.ndarray | None = None
        self.publishes = 0

    def maybe_publish(self, t: float) -> bool:
        """Publish if ``t`` is at least one period after the last publish
        (first call always publishes).  A BACKWARDS time jump (looped bag
        replay, clock reset) is treated as a reset and publishes, as ROS
        nodes do on sim-time jumps.  Returns whether it fired."""
        if (
            self._last_time is not None
            and 0.0 <= t - self._last_time < self.period
        ):
            return False
        self.publish(t)
        return True

    def publish(self, t: float) -> None:
        """Unconditional export + fire (the reference's first-scan path)."""
        img = np.asarray(self.exporter())
        delta = self._delta(img)
        self._last_time = t
        self._last_img = img
        self.publishes += 1
        self.bus.fire(
            self.event,
            time=t,
            image=img,
            shape=tuple(img.shape),
            **delta,
        )

    def _delta(self, img: np.ndarray) -> dict:
        """Changed-cell summary vs the previous publish.

        ``changed`` counts differing cells; ``bbox`` is the (row0, col0,
        row1, col1) inclusive bounds of the change, or None when nothing
        changed (or shapes differ — e.g. a grid re-size, treated as a full
        refresh)."""
        prev = self._last_img
        if prev is None or prev.shape != img.shape:
            return {"changed": int(img.size), "bbox": None, "full": True}
        diff = img != prev
        n = int(diff.sum())
        if n == 0:
            return {"changed": 0, "bbox": None, "full": False}
        rows = np.flatnonzero(diff.any(axis=1))
        cols = np.flatnonzero(diff.any(axis=0))
        return {
            "changed": n,
            "bbox": (int(rows[0]), int(cols[0]), int(rows[-1]), int(cols[-1])),
            "full": False,
        }
