"""Scan-log ingestion (counterpart of ``tpuslam/io/bag.py``): the
replacement for rosbag playback.

A ``ScanLog`` holds a recorded or synthesized scan stream on the host in
NumPy; ``ScanLog.scan`` / ``scans_batched`` hand the engines the port's
``Scan`` tensors on an explicit device.  Logs come from the ``.tslg``
binary format, the ``.npz`` interchange format, a ROS1 ``.bag``
(``io/rosbag.py``) or the synthetic-world generator, so every workload
runs without an external dataset.

The ``.tslg`` codec reads and writes NumPy record arrays
(``codec="python"``, the default).  The native C++ codec
(``codec="native"``: ``tpuslam_torch/csrc/scanlog.cc``, built at first use
with the host C++ compiler by ``io/_native.py``; a failed build raises)
writes the same bytes; it loads a 160 x 1081 log in 3.1-4.0 ms against the
record arrays' 0.49-0.59 ms (it reads a field at a time; PERF.md), so it
is the choice only where a caller wants the reference's C++ path.  Files
written by either codec, or by the JAX package, load in the others.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct

import numpy as np

from tpuslam_torch.core.scan import Scan, make_scan

_MAGIC = b"TSLG"
_VERSION = 1
# header after the magic: version, beams, scans, angle_min,
# angle_increment, range_min, range_max, time_increment
_HEADER = "<IIIfffff"


@dataclasses.dataclass
class ScanLog:
    """A recorded (or synthesized) scan stream with odometry + gyro."""

    ranges: np.ndarray  # [T, B] float32 (inf/nan = invalid)
    stamps: np.ndarray  # [T] float64 seconds
    odom: np.ndarray  # [T, 3] float32 odometric poses
    imu_wz: np.ndarray  # [T] float32 yaw rate at each scan
    angle_min: float
    angle_increment: float
    range_min: float
    range_max: float
    time_increment: float = 0.0
    # rosbag-derived TF metadata (not persisted by the tslg/npz codecs):
    # the scan frame_id and the bag's static frame tree
    # (tpuslam_torch.core.frames.FrameTree), when the source bag carried
    # /tf_static — lets the CLI resolve the laser extrinsic the way the
    # reference nodes look it up from TF (karto_slam.cc:327-405).
    laser_frame: str | None = None
    frames: object | None = None

    def __len__(self) -> int:
        return self.ranges.shape[0]

    @property
    def num_beams(self) -> int:
        return self.ranges.shape[1]

    def scan(self, i: int, num_beams: int | None = None,
             device="cuda") -> Scan:
        return make_scan(
            self.ranges[i],
            angle_min=self.angle_min,
            angle_increment=self.angle_increment,
            range_min=self.range_min,
            range_max=self.range_max,
            time_increment=self.time_increment,
            num_beams=num_beams or self.num_beams,
            device=device,
        )

    def scans_batched(self, num_beams: int | None = None,
                      device="cuda") -> Scan:
        """All scans stacked into one Scan [T, B], built in one transfer."""
        return make_scan(
            self.ranges,
            angle_min=self.angle_min,
            angle_increment=self.angle_increment,
            range_min=self.range_min,
            range_max=self.range_max,
            time_increment=self.time_increment,
            num_beams=num_beams or self.num_beams,
            device=device,
        )


def _record_dtype(b: int) -> np.dtype:
    """One scan's packed record: stamp f64, odom 3 x f32, yaw rate f32,
    ranges b x f32 (little-endian, no padding)."""
    return np.dtype([("stamp", "<f8"), ("odom", "<f4", (3,)),
                     ("wz", "<f4"), ("ranges", "<f4", (b,))])


CODECS = ("native", "python")


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown .tslg codec {codec!r}; known: {CODECS}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def save_tslg(path: str | os.PathLike, log: ScanLog,
              codec: str = "python") -> None:
    """Write a .tslg binary log with NumPy record arrays or the native
    codec (``codec="native"``): the same bytes."""
    _check_codec(codec)
    t, b = log.ranges.shape
    stamps = np.ascontiguousarray(log.stamps, np.float64)
    odom = np.ascontiguousarray(log.odom, np.float32)
    wz = np.ascontiguousarray(log.imu_wz, np.float32)
    # NaN/inf beams are the documented invalid encoding and round-trip
    # verbatim — f32 represents them exactly
    ranges = np.ascontiguousarray(log.ranges, np.float32)
    if codec == "native":
        from tpuslam_torch.io import _native

        rc = _native.load().tslg_write(
            os.fsencode(path), b, t, log.angle_min, log.angle_increment,
            log.range_min, log.range_max, log.time_increment,
            _ptr(stamps), _ptr(odom), _ptr(wz), _ptr(ranges))
        if rc != 0:
            raise IOError(f"tslg_write failed ({rc}) for {path}")
        return
    rec = np.empty(t, _record_dtype(b))
    rec["stamp"] = stamps
    rec["odom"] = odom
    rec["wz"] = wz
    rec["ranges"] = ranges
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(_HEADER, _VERSION, b, t, log.angle_min,
                            log.angle_increment, log.range_min,
                            log.range_max, log.time_increment))
        f.write(rec.tobytes())


def _load_native(path) -> ScanLog:
    from tpuslam_torch.io import _native

    lib = _native.load()
    meta = np.zeros(5, np.float64)
    counts = np.zeros(2, np.int64)
    h = lib.tslg_open(os.fsencode(path), _ptr(meta), _ptr(counts))
    if not h:
        raise IOError(f"tslg_open failed for {path} (missing, bad magic "
                      "or version, or a short header)")
    try:
        b, t = int(counts[0]), int(counts[1])
        stamps = np.empty(t, np.float64)
        odom = np.empty((t, 3), np.float32)
        wz = np.empty(t, np.float32)
        ranges = np.empty((t, b), np.float32)
        rc = lib.tslg_read(h, 0, t, _ptr(stamps), _ptr(odom), _ptr(wz),
                           _ptr(ranges))
        if rc != 0:
            raise IOError(f"tslg_read failed ({rc}) for {path}: truncated "
                          "file")
    finally:
        lib.tslg_close(h)
    return ScanLog(ranges, stamps, odom, wz, *(float(m) for m in meta))


def load_tslg(path: str | os.PathLike, codec: str = "python") -> ScanLog:
    """Read a .tslg binary log with NumPy record arrays or the native
    codec (``codec="native"``); a bad magic number, another version or a
    truncated file raises ``IOError`` in both."""
    _check_codec(codec)
    if codec == "native":
        return _load_native(path)
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise IOError(f"bad magic in {path}")
        header = f.read(struct.calcsize(_HEADER))
        if len(header) != struct.calcsize(_HEADER):
            raise IOError(f"truncated tslg header in {path}")
        ver, b, t, amin, ainc, rmin, rmax, tinc = struct.unpack(
            _HEADER, header)
        if ver != _VERSION:
            raise IOError(f"unsupported tslg version {ver}")
        dt = _record_dtype(b)
        body = f.read(t * dt.itemsize)
    if len(body) != t * dt.itemsize:
        raise IOError(f"truncated tslg file {path}")
    rec = np.frombuffer(body, dt)
    return ScanLog(
        np.array(rec["ranges"], np.float32), np.array(rec["stamp"]),
        np.array(rec["odom"], np.float32), np.array(rec["wz"], np.float32),
        amin, ainc, rmin, rmax, tinc,
    )


# --------------------------------------------------------------- npz + synth
def save_npz(path: str | os.PathLike, log: ScanLog) -> None:
    np.savez_compressed(
        path,
        ranges=log.ranges,
        stamps=log.stamps,
        odom=log.odom,
        imu_wz=log.imu_wz,
        meta=np.array(
            [log.angle_min, log.angle_increment, log.range_min,
             log.range_max, log.time_increment]
        ),
    )


def load_npz(path: str | os.PathLike) -> ScanLog:
    z = np.load(path)
    m = z["meta"]
    return ScanLog(
        z["ranges"], z["stamps"], z["odom"], z["imu_wz"],
        float(m[0]), float(m[1]), float(m[2]), float(m[3]), float(m[4]),
    )


def load(path: str | os.PathLike) -> ScanLog:
    p = str(path)
    if p.endswith(".npz"):
        return load_npz(p)
    if p.endswith(".bag"):
        from tpuslam_torch.io.rosbag import bag_to_scanlog

        return bag_to_scanlog(p)
    return load_tslg(p)


def synthesize(
    *,
    world: str = "boxes",
    trajectory: str = "circle",
    num_scans: int = 100,
    num_beams: int = 360,
    rate_hz: float = 10.0,
    odom_noise: tuple[float, float, float] = (0.01, 0.01, 0.005),
    range_noise: float = 0.0,
    max_range: float = 30.0,
    radius: float = 1.6,
    poses_per_rev: int = 40,
    seed: int = 0,
    distorted: bool = False,
) -> tuple[ScanLog, np.ndarray]:
    """Generate a synthetic scan log + ground-truth poses [T, 3], the
    JAX package's ``synthesize`` on the port's copy of the worlds (the
    same log bit for bit).

    ``distorted=True`` simulates rolling-shutter motion distortion: scan
    i's beams are cast from the poses the robot actually sweeps through
    between true[i] and true[i+1] (constant body twist), the physical
    effect lesson5's undistortion node corrects.  Scan i's beam-0 frame
    is true[i] and its sweep spans [stamps[i], stamps[i+1]]."""
    from tpuslam_torch.io.simulate import (
        rect_room,
        simulate_distorted_scan,
        simulate_scan,
        world_with_boxes,
    )

    rng = np.random.default_rng(seed)
    segs = world_with_boxes() if world == "boxes" else rect_room(10.0, 8.0)
    if trajectory == "circle":
        # poses_per_rev poses per revolution, num_scans poses total
        s = np.linspace(0, 2 * np.pi * num_scans / poses_per_rev, num_scans,
                        endpoint=False)
        true = np.stack(
            [radius * np.cos(s), radius * np.sin(s),
             np.arctan2(np.cos(s), -np.sin(s))], axis=-1
        )
    else:  # "line"
        x = np.linspace(-3, 3, num_scans)
        true = np.stack([x, np.zeros_like(x), np.zeros_like(x)], axis=-1)

    dt = 1.0 / rate_hz
    ranges = np.zeros((num_scans, num_beams), np.float32)
    amin = ainc = 0.0
    for i, p in enumerate(true):
        if distorted and i + 1 < num_scans:
            a, b = true[i], true[i + 1]
            ca, sa = np.cos(a[2]), np.sin(a[2])
            d = b[:2] - a[:2]
            twist = np.array([
                (ca * d[0] + sa * d[1]) / dt,
                (-sa * d[0] + ca * d[1]) / dt,
                np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2])) / dt,
            ])
            r, amin, ainc, _ = simulate_distorted_scan(
                segs, p, twist, num_beams=num_beams, max_range=max_range,
                scan_period=dt,
            )
            if range_noise > 0.0:
                r = np.where(np.isfinite(r),
                             r + rng.normal(0, range_noise, r.shape), r)
        else:
            r, amin, ainc = simulate_scan(
                segs, p, num_beams=num_beams, max_range=max_range,
                noise_std=range_noise, rng=rng,
            )
        ranges[i] = r.astype(np.float32)

    # noisy odometry integration + per-scan yaw rate
    odom = np.zeros_like(true)
    odom[0] = true[0]
    wz = np.zeros(num_scans, np.float32)
    for i in range(1, num_scans):
        a, b = true[i - 1], true[i]
        ca, sa = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        rel = np.array(
            [ca * d[0] + sa * d[1], -sa * d[0] + ca * d[1],
             np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))]
        )
        rel = rel + rng.normal(0, odom_noise)
        co, so = np.cos(odom[i - 1, 2]), np.sin(odom[i - 1, 2])
        odom[i] = [
            odom[i - 1, 0] + co * rel[0] - so * rel[1],
            odom[i - 1, 1] + so * rel[0] + co * rel[1],
            np.arctan2(np.sin(odom[i - 1, 2] + rel[2]),
                       np.cos(odom[i - 1, 2] + rel[2])),
        ]
        wz[i] = rel[2] / dt

    log = ScanLog(
        ranges=ranges,
        stamps=np.arange(num_scans, dtype=np.float64) * dt,
        odom=odom.astype(np.float32),
        imu_wz=wz,
        angle_min=float(amin),
        angle_increment=float(ainc),
        range_min=0.1,
        range_max=float(max_range),
        # per-beam firing interval: beam B-1 fires dt after beam 0,
        # matching simulate_distorted_scan's sweep
        time_increment=dt / max(num_beams - 1, 1),
    )
    return log, true
