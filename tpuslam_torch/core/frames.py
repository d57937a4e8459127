"""Static frame tree + per-laser extrinsics (the reference's TF usage):
a copy of ``tpuslam/core/frames.py`` (NumPy only), so that the port
imports nothing of the JAX package.

The reference relies on ROS TF for two static jobs its SLAM math needs
(dynamic odom/map frames are the engines' own state): composing each
sensor's mounting transform (``base_to_laser``, looked up once —
plicp_odometry.cc:257-280, karto_slam.cc:335-349) and detecting
upside-down-mounted lasers by transforming an "up" point into the laser
frame (karto_slam.cc:357-377).  This module is the
replacement: a small host-side tree of STATIC 3-D transforms (SLAM runs
in the plane; the third dimension exists only so roll/pitch-mounted
sensors — e.g. an inverted laser — resolve correctly), with planar
projections for the engines.

Per-laser bookkeeping mirrors SlamKarto::getLaser/addScan
(karto_slam.cc:327-434): one registry entry per laser frame holding the
planar offset pose and the inverted flag; staging a scan from an
inverted laser REVERSES its range array (karto_slam.cc:417-425 iterates
``ranges.rbegin()..rend()``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Intrinsic ZYX (yaw-pitch-roll) rotation, the ROS/tf convention."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


@dataclasses.dataclass(frozen=True)
class Transform3:
    """A rigid 3-D transform (rotation + translation), float64."""

    rotation: tuple  # 3x3 nested tuple (hashable)
    translation: tuple  # xyz

    @staticmethod
    def from_xyz_rpy(x=0.0, y=0.0, z=0.0, roll=0.0, pitch=0.0, yaw=0.0):
        r = _rpy_matrix(roll, pitch, yaw)
        return Transform3(tuple(map(tuple, r)), (x, y, z))

    @property
    def r(self) -> np.ndarray:
        return np.array(self.rotation)

    @property
    def t(self) -> np.ndarray:
        return np.array(self.translation)

    def compose(self, other: "Transform3") -> "Transform3":
        r = self.r @ other.r
        t = self.r @ other.t + self.t
        return Transform3(tuple(map(tuple, r)), tuple(t))

    def inverse(self) -> "Transform3":
        rt = self.r.T
        return Transform3(tuple(map(tuple, rt)), tuple(-rt @ self.t))

    def apply(self, point) -> np.ndarray:
        return self.r @ np.asarray(point, np.float64) + self.t

    def planar(self) -> np.ndarray:
        """(x, y, yaw) projection — what the 2-D engines consume.

        yaw via atan2 of the rotated x-axis (tf::getYaw equivalent for
        mostly-planar mounts)."""
        r = self.r
        return np.array(
            [self.t[0], self.t[1], math.atan2(r[1, 0], r[0, 0])]
        )


class FrameTree:
    """Static extrinsics: named frames connected by rigid transforms.

    ``add(parent, child, tf)`` declares child's pose in parent;
    ``lookup(target, source)`` returns the transform taking SOURCE-frame
    coordinates into TARGET-frame coordinates (TF semantics), walking
    through the common ancestor."""

    def __init__(self, root: str = "base_link"):
        self.root = root
        self._parent: dict[str, tuple[str, Transform3]] = {}

    def add(self, parent: str, child: str, tf: Transform3) -> None:
        if child == self.root or child in self._parent:
            raise ValueError(f"frame {child!r} already defined")
        # cycle guard: parent chain must reach the root (or be the root)
        seen = {child}
        p = parent
        while p != self.root:
            if p in seen or p not in self._parent:
                raise ValueError(
                    f"parent frame {parent!r} not connected to root "
                    f"{self.root!r}"
                )
            seen.add(p)
            p = self._parent[p][0]
        self._parent[child] = (parent, tf)

    def _to_root(self, frame: str) -> Transform3:
        tf = Transform3.from_xyz_rpy()
        while frame != self.root:
            if frame not in self._parent:
                raise KeyError(f"unknown frame {frame!r}")
            parent, t = self._parent[frame]
            tf = t.compose(tf)
            frame = parent
        return tf

    def lookup(self, target: str, source: str) -> Transform3:
        return self._to_root(target).inverse().compose(
            self._to_root(source)
        )

    def planar(self, target: str, source: str) -> np.ndarray:
        """(x, y, yaw) of source's origin/heading in target coordinates —
        e.g. ``planar('base_link', 'laser')`` is the karto offset pose /
        the plicp ``base_to_laser`` (plicp_odometry.cc:257-280)."""
        return self.lookup(target, source).planar()

    def is_upside_down(self, laser_frame: str, base_frame: str | None = None
                       ) -> bool:
        """The reference's inversion probe (karto_slam.cc:357-377): take a
        point 1 m above the laser in the BASE frame and transform it into
        the laser frame; z <= 0 means the laser is mounted upside-down."""
        base = base_frame or self.root
        laser_in_base = self.lookup(base, laser_frame)
        up_base = np.array(
            [laser_in_base.t[0], laser_in_base.t[1],
             1.0 + laser_in_base.t[2]]
        )
        up_laser = self.lookup(laser_frame, base).apply(up_base)
        return bool(up_laser[2] <= 0.0)


@dataclasses.dataclass
class LaserInfo:
    """Per-laser registration (SlamKarto::getLaser, karto_slam.cc:327-405)."""

    frame: str
    offset_pose: np.ndarray  # [3] (x, y, yaw) in the base frame
    inverted: bool


class LaserRegistry:
    """Lazy per-frame laser registration + inverted-scan staging."""

    def __init__(self, frames: FrameTree, base_frame: str | None = None):
        self.frames = frames
        self.base_frame = base_frame or frames.root
        self.lasers: dict[str, LaserInfo] = {}

    def get(self, laser_frame: str) -> LaserInfo:
        if laser_frame not in self.lasers:
            self.lasers[laser_frame] = LaserInfo(
                frame=laser_frame,
                offset_pose=self.frames.planar(self.base_frame, laser_frame),
                inverted=self.frames.is_upside_down(
                    laser_frame, self.base_frame
                ),
            )
        return self.lasers[laser_frame]

    def stage_ranges(self, laser_frame: str, ranges) -> np.ndarray:
        """Ranges in processing order: reversed for inverted lasers
        (karto_slam.cc:417-425)."""
        r = np.asarray(ranges)
        return r[::-1].copy() if self.get(laser_frame).inverted else r

    def sensor_pose(self, laser_frame: str, base_pose) -> np.ndarray:
        """World pose of the laser: base pose ∘ offset (the pre-composition
        KartoMapper's caller contract expects, models/karto.py)."""
        p = np.asarray(base_pose, np.float64)
        o = self.get(laser_frame).offset_pose
        c, s = math.cos(p[2]), math.sin(p[2])
        return np.array(
            [
                p[0] + c * o[0] - s * o[1],
                p[1] + s * o[0] + c * o[1],
                math.atan2(math.sin(p[2] + o[2]), math.cos(p[2] + o[2])),
            ]
        )
