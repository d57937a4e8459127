"""rosbag (v1, format 2.0) → ScanLog bridge: a copy of
``tpuslam/io/rosbag.py`` (NumPy only), kept so that the port imports
nothing of the JAX package; only the imports name the port's modules.

The reference's entire data plane is recorded rosbags (every
``lesson*/launch/*.launch`` ends in ``rosbag play``, e.g.
lesson6/launch/karto_slam_outdoor.launch:24-26).  This module ingests those
bags host-side — pure Python, no ROS — and converts the LaserScan + odometry
(+ IMU) streams into :class:`tpuslam_torch.io.bag.ScanLog`, unlocking the
BASELINE.md ATE-parity runs on the author's datasets.

Implements the rosbag 2.0 container format (records with name=value headers,
chunked message storage, none/bz2/lz4 chunk compression) and the ROS1 binary
message serialization for the message types the lessons consume:
``sensor_msgs/LaserScan``, ``nav_msgs/Odometry``, ``sensor_msgs/Imu``, and
``tf2_msgs/TFMessage`` (``/tf`` + ``/tf_static``).  Real recordings usually
carry odometry via the TF tree rather than an Odometry topic: the reference
looks up odom→base at each scan stamp (SlamKarto::getOdomPose,
lesson6/src/karto_slam.cc:483-505) and composes base↔laser from TF
(plicp_odometry.cc:257-280); :class:`TfBuffer` + the fallback in
:func:`bag_to_scanlog` reproduce both lookups host-side.
A minimal writer produces spec-conformant fixture bags for round-trip tests.
"""

from __future__ import annotations

import bz2
import dataclasses
import math
import struct
from pathlib import Path

import numpy as np

from tpuslam_torch.io.bag import ScanLog

_VERSION_LINE = b"#ROSBAG V2.0\n"

# record op codes (rosbag/bag.py in ros_comm)
OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict[str, bytes]:
    fields: dict[str, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name.decode()] = value
    return fields


def _read_record(data: bytes, off: int) -> tuple[dict[str, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    header = _parse_header(data[off : off + hlen])
    off += hlen
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    payload = data[off : off + dlen]
    off += dlen
    return header, payload, off


@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str
    time: float  # bag receive time (s)
    raw: bytes  # serialized ROS1 message body


def read_bag(path) -> list[BagMessage]:
    """Sequentially read every message record of a rosbag v1 file.

    Index/chunk-info records are skipped (no random access needed for a
    full-log conversion); chunk compression none, bz2 and lz4 are all
    supported (lz4 via the system liblz4, io/_lz4.py)."""
    data = Path(path).read_bytes()
    if not data.startswith(_VERSION_LINE):
        raise ValueError(
            f"{path}: not a rosbag v2.0 file "
            f"(header {data[:13]!r}); rosbag v1.x and rosbag2/sqlite are "
            f"not supported"
        )
    connections: dict[int, tuple[str, str]] = {}  # conn id -> (topic, type)
    messages: list[BagMessage] = []

    def handle_records(buf: bytes):
        off = 0
        while off < len(buf):
            header, payload, off = _read_record(buf, off)
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                (conn,) = struct.unpack("<I", header["conn"])
                conn_fields = _parse_header(payload)
                topic = header.get(
                    "topic", conn_fields.get("topic", b"")
                ).decode()
                mtype = conn_fields.get("type", b"").decode()
                connections[conn] = (topic, mtype)
            elif op == OP_MSG_DATA:
                (conn,) = struct.unpack("<I", header["conn"])
                secs, nsecs = struct.unpack("<II", header["time"])
                topic, mtype = connections.get(conn, ("?", "?"))
                messages.append(
                    BagMessage(topic, mtype, secs + nsecs * 1e-9, payload)
                )
            elif op == OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "none":
                    inner = payload
                elif comp == "bz2":
                    inner = bz2.decompress(payload)
                elif comp == "lz4":
                    # roslz4 writes standard LZ4 frames: decode with the
                    # system liblz4 (io/_lz4.py ctypes binding); fall back
                    # to the optional lz4 wheel if the .so is absent
                    from tpuslam_torch.io import _lz4

                    if _lz4.available():
                        inner = _lz4.decompress(payload)
                    else:  # pragma: no cover
                        try:
                            import lz4.frame  # type: ignore
                        except ImportError as e:
                            raise ValueError(
                                "bag uses lz4 chunk compression; liblz4 "
                                "and the lz4 package are both unavailable"
                            ) from e
                        inner = lz4.frame.decompress(payload)
                else:
                    raise ValueError(f"unknown chunk compression {comp!r}")
                handle_records(inner)
            # OP_BAG_HEADER / OP_INDEX_DATA / OP_CHUNK_INFO: skip

    handle_records(data[len(_VERSION_LINE) :])
    return messages


# --------------------------------------------------------------------------
# ROS1 message deserialization (little-endian)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f32(self) -> float:
        (v,) = struct.unpack_from("<f", self.buf, self.off)
        self.off += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def f64s(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.buf, "<f8", n, self.off)
        self.off += 8 * n
        return out

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def time(self) -> float:
        secs, nsecs = self.u32(), self.u32()
        return secs + nsecs * 1e-9

    def header(self) -> tuple[int, float, str]:
        return self.u32(), self.time(), self.string()

    def f32_array(self) -> np.ndarray:
        n = self.u32()
        out = np.frombuffer(self.buf, "<f4", n, self.off)
        self.off += 4 * n
        return out


def parse_laser_scan(raw: bytes) -> dict:
    r = _Reader(raw)
    _, stamp, frame = r.header()
    out = {
        "stamp": stamp,
        "frame_id": frame,
        "angle_min": r.f32(),
        "angle_max": r.f32(),
        "angle_increment": r.f32(),
        "time_increment": r.f32(),
        "scan_time": r.f32(),
        "range_min": r.f32(),
        "range_max": r.f32(),
        "ranges": r.f32_array(),
    }
    out["intensities"] = r.f32_array()
    return out


def _yaw_from_quat(x: float, y: float, z: float, w: float) -> float:
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def parse_odometry(raw: bytes) -> dict:
    r = _Reader(raw)
    _, stamp, frame = r.header()
    child = r.string()
    px, py, pz = r.f64(), r.f64(), r.f64()
    qx, qy, qz, qw = r.f64(), r.f64(), r.f64(), r.f64()
    r.f64s(36)  # pose covariance
    lx, ly, lz = r.f64(), r.f64(), r.f64()
    ax, ay, az = r.f64(), r.f64(), r.f64()
    r.f64s(36)  # twist covariance
    return {
        "stamp": stamp,
        "frame_id": frame,
        "child_frame_id": child,
        "pose": np.array([px, py, _yaw_from_quat(qx, qy, qz, qw)]),
        "linear": np.array([lx, ly, lz]),
        "angular": np.array([ax, ay, az]),
    }


def parse_imu(raw: bytes) -> dict:
    r = _Reader(raw)
    _, stamp, frame = r.header()
    r.f64s(4)  # orientation quaternion
    r.f64s(9)
    wx, wy, wz = r.f64(), r.f64(), r.f64()
    r.f64s(9)
    r.f64s(3)  # linear acceleration
    r.f64s(9)
    return {"stamp": stamp, "frame_id": frame, "w": np.array([wx, wy, wz])}


def parse_tf_message(raw: bytes) -> list[dict]:
    """tf2_msgs/TFMessage (also the legacy tf/tfMessage — same wire
    layout): an array of geometry_msgs/TransformStamped."""
    r = _Reader(raw)
    n = r.u32()
    out = []
    for _ in range(n):
        _, stamp, parent = r.header()
        child = r.string()
        t = r.f64s(3)
        q = r.f64s(4)  # (x, y, z, w)
        out.append(
            {"stamp": stamp, "parent": parent, "child": child,
             "t": np.asarray(t), "q": np.asarray(q)}
        )
    return out


# --------------------------------------------------------------------------
# TF buffer: time-interpolated transform lookups (tf2_ros::Buffer analog)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    n = math.sqrt(x * x + y * y + z * z + w * w) or 1.0
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _quat_slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    """Shortest-path spherical interpolation (tf2::slerp semantics)."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:  # nearly parallel: lerp + renormalize
        q = q0 + u * (q1 - q0)
        return q / np.linalg.norm(q)
    th = math.acos(min(1.0, d))
    s = math.sin(th)
    return (math.sin((1.0 - u) * th) * q0 + math.sin(u * th) * q1) / s


class TfBuffer:
    """Host-side TF tree with time interpolation.

    The reference's nodes delegate two lookups to tf2_ros::Buffer:
    odom→base at each scan stamp (karto_slam.cc:483-505) and the static
    base↔laser extrinsic (plicp_odometry.cc:257-280).  This buffer
    reproduces ``lookupTransform`` for a recorded bag: static edges are
    timeless, dynamic edges interpolate (lerp translation / slerp
    rotation, clamped at the ends — a bag replay never extrapolates
    beyond its own recording)."""

    def __init__(self):
        # child -> (parent, t[3], q[4]) for static edges
        self._static: dict[str, tuple[str, np.ndarray, np.ndarray]] = {}
        # child -> parent for dynamic edges; samples keyed by child
        self._dyn_parent: dict[str, str] = {}
        self._dyn: dict[str, list[tuple[float, np.ndarray, np.ndarray]]] = {}
        self._sorted: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def insert(self, tr: dict, static: bool = False) -> None:
        if static:
            self._static[tr["child"]] = (tr["parent"], tr["t"], tr["q"])
        else:
            self._dyn_parent[tr["child"]] = tr["parent"]
            self._dyn.setdefault(tr["child"], []).append(
                (tr["stamp"], tr["t"], tr["q"])
            )
            self._sorted.pop(tr["child"], None)

    # -- edge accessors ----------------------------------------------------
    def dynamic_edges(self) -> list[tuple[str, str]]:
        return [(p, c) for c, p in self._dyn_parent.items()]

    def static_edges(self) -> list[tuple[str, str]]:
        return [(p, c) for c, (p, _, _) in self._static.items()]

    def _parent_of(self, frame: str) -> str | None:
        # dynamic wins if a frame somehow appears in both
        if frame in self._dyn_parent:
            return self._dyn_parent[frame]
        if frame in self._static:
            return self._static[frame][0]
        return None

    def _edge(self, child: str, time: float) -> tuple[np.ndarray, np.ndarray]:
        """(t, q) of child's pose in its parent at ``time``."""
        if child in self._dyn_parent:
            if child not in self._sorted:
                samples = sorted(self._dyn[child], key=lambda s: s[0])
                self._sorted[child] = (
                    np.array([s[0] for s in samples]),
                    np.stack([s[1] for s in samples]),
                    np.stack([s[2] for s in samples]),
                )
            ts, tt, qq = self._sorted[child]
            i = int(np.searchsorted(ts, time))
            if i <= 0:
                return tt[0], qq[0]
            if i >= len(ts):
                return tt[-1], qq[-1]
            u = (time - ts[i - 1]) / max(ts[i] - ts[i - 1], 1e-12)
            return (
                tt[i - 1] + u * (tt[i] - tt[i - 1]),
                _quat_slerp(qq[i - 1], qq[i], float(u)),
            )
        _, t, q = self._static[child]
        return t, q

    # -- lookups -------------------------------------------------------------
    def _chain_up(self, frame: str, time: float):
        """[(ancestor_name, Transform3 frame→ancestor)] root-ward,
        starting with (frame, identity)."""
        from tpuslam_torch.core.frames import Transform3

        out = [(frame, Transform3.from_xyz_rpy())]
        cur, tf = frame, out[0][1]
        seen = {frame}
        while True:
            parent = self._parent_of(cur)
            if parent is None or parent in seen:
                return out
            t, q = self._edge(cur, time)
            step = _make_transform3(t, q)
            tf = step.compose(tf)
            out.append((parent, tf))
            seen.add(parent)
            cur = parent

    def lookup(self, target: str, source: str, time: float):
        """Transform taking SOURCE-frame coordinates into TARGET-frame
        coordinates at ``time`` (tf2 lookupTransform semantics)."""
        src = self._chain_up(source, time)
        tgt = self._chain_up(target, time)
        tgt_names = {n: tf for n, tf in tgt}
        for name, tf_src in src:
            if name in tgt_names:
                return tgt_names[name].inverse().compose(tf_src)
        raise KeyError(
            f"no TF chain connects {source!r} to {target!r}"
        )

    def can_transform(self, target: str, source: str) -> bool:
        try:
            self.lookup(target, source, 0.0)
            return True
        except KeyError:
            return False

    def static_connected(self, ancestor: str, frame: str) -> bool:
        """True if ``frame`` reaches ``ancestor`` via static edges only."""
        cur = frame
        seen = set()
        while cur != ancestor:
            if cur in seen or cur not in self._static:
                return False
            seen.add(cur)
            cur = self._static[cur][0]
        return True

    def static_frame_tree(self, root: str):
        """Export the static subtree under ``root`` as a
        core.frames.FrameTree (the registry the CLI's laser handling
        consumes — SlamKarto::getLaser parity, karto_slam.cc:327-405)."""
        from tpuslam_torch.core.frames import FrameTree

        ft = FrameTree(root)
        children: dict[str, list[str]] = {}
        for child, (parent, _, _) in self._static.items():
            children.setdefault(parent, []).append(child)
        queue = [root]
        while queue:
            parent = queue.pop(0)
            for child in sorted(children.get(parent, ())):
                t, q = self._static[child][1], self._static[child][2]
                ft.add(parent, child, _make_transform3(t, q))
                queue.append(child)
        return ft


def _make_transform3(t: np.ndarray, q: np.ndarray):
    from tpuslam_torch.core.frames import Transform3

    return Transform3(tuple(map(tuple, _quat_to_mat(q))), tuple(map(float, t)))


# --------------------------------------------------------------------------
# conversion

_SCAN_TYPE = "sensor_msgs/LaserScan"
_ODOM_TYPE = "nav_msgs/Odometry"
_IMU_TYPE = "sensor_msgs/Imu"
_TF_TYPES = ("tf2_msgs/TFMessage", "tf/tfMessage")


def _build_tf_buffer(msgs: list[BagMessage]) -> TfBuffer:
    buf = TfBuffer()
    for m in msgs:
        if m.msg_type not in _TF_TYPES:
            continue
        static = m.topic.rstrip("/").endswith("tf_static")
        for tr in parse_tf_message(m.raw):
            buf.insert(tr, static=static)
    return buf


def _detect_odom_edge(
    buf: TfBuffer,
    laser_frame: str,
    base_frame: str | None,
    odom_frame: str | None,
) -> tuple[str, str] | None:
    """Pick the dynamic TF edge that plays odom→base.

    Preference order: an explicit (odom_frame, base_frame) match, then the
    dynamic edge whose child statically reaches the laser frame (the
    robot-model shape every reference launch uses: odom→base_link with the
    laser mounted statically under base_link), then a name heuristic."""
    edges = buf.dynamic_edges()
    if not edges:
        return None
    cands = [
        (p, c)
        for p, c in edges
        if (odom_frame is None or p == odom_frame)
        and (base_frame is None or c == base_frame)
    ]
    if not cands:
        return None
    if len(cands) > 1:
        linked = [
            (p, c)
            for p, c in cands
            if c == laser_frame or buf.static_connected(c, laser_frame)
        ]
        if linked:
            cands = linked
    cands.sort(key=lambda pc: (0 if "odom" in pc[0] else 1, pc[0], pc[1]))
    return cands[0]


def bag_to_scanlog(
    path,
    scan_topic: str | None = None,
    odom_topic: str | None = None,
    imu_topic: str | None = None,
    base_frame: str | None = None,
    odom_frame: str | None = None,
) -> ScanLog:
    """Convert a rosbag into a ScanLog.

    Topic auto-detection picks the first topic of each message type.  Odom
    poses are linearly interpolated (yaw circularly) to each scan's header
    stamp — the TF-lookup-at-scan-time the reference nodes perform
    (e.g. plicp_odometry.cc:352-370); the gyro yaw rate comes from the IMU
    stream when present, else from odom twist, else zeros.

    Bags with no Odometry topic fall back to the TF tree, exactly as the
    reference obtains odometry: odom→base is looked up at each scan stamp
    (SlamKarto::getOdomPose, karto_slam.cc:483-505) from the ``/tf``
    stream, with the odom→base edge auto-detected (override with
    ``base_frame`` / ``odom_frame``).  When ``/tf_static`` is present the
    returned log also carries ``frames`` (the static FrameTree rooted at
    the base frame) and ``laser_frame`` (the scan header's frame_id), so
    callers can resolve the base↔laser extrinsic and inverted mounts
    through core.frames.LaserRegistry (plicp_odometry.cc:257-280,
    karto_slam.cc:327-405)."""
    msgs = read_bag(path)

    def pick(explicit, mtype):
        if explicit is not None:
            return explicit
        for m in msgs:
            if m.msg_type == mtype:
                return m.topic
        return None

    scan_topic = pick(scan_topic, _SCAN_TYPE)
    if scan_topic is None:
        raise ValueError(f"{path}: no {_SCAN_TYPE} messages found")
    odom_topic = pick(odom_topic, _ODOM_TYPE)
    imu_topic = pick(imu_topic, _IMU_TYPE)

    scans = [
        parse_laser_scan(m.raw) for m in msgs if m.topic == scan_topic
    ]
    odoms = [parse_odometry(m.raw) for m in msgs if m.topic == odom_topic]
    imus = [parse_imu(m.raw) for m in msgs if m.topic == imu_topic]
    scans.sort(key=lambda s: s["stamp"])
    odoms.sort(key=lambda o: o["stamp"])
    imus.sort(key=lambda o: o["stamp"])

    first = scans[0]
    nb = len(first["ranges"])
    t = len(scans)
    ranges = np.full((t, nb), np.inf, np.float32)
    stamps = np.zeros(t, np.float64)
    for i, s in enumerate(scans):
        r = s["ranges"][:nb]
        ranges[i, : len(r)] = r
        stamps[i] = s["stamp"]

    tf_buf = _build_tf_buffer(msgs)
    laser_frame = first.get("frame_id") or "laser"

    odom_out = np.zeros((t, 3), np.float32)
    if odoms:
        ot = np.array([o["stamp"] for o in odoms])
        op = np.stack([o["pose"] for o in odoms])
        ox = np.interp(stamps, ot, op[:, 0])
        oy = np.interp(stamps, ot, op[:, 1])
        # circular yaw interpolation
        oyaw = np.arctan2(
            np.interp(stamps, ot, np.sin(op[:, 2])),
            np.interp(stamps, ot, np.cos(op[:, 2])),
        )
        odom_out = np.stack([ox, oy, oyaw], axis=-1).astype(np.float32)
    else:
        # TF fallback: getOdomPose at each scan stamp
        # (karto_slam.cc:483-505 — pose of base_frame in odom_frame)
        edge = _detect_odom_edge(tf_buf, laser_frame, base_frame, odom_frame)
        if edge is not None:
            o_frame, b_frame = edge
            odom_out = np.stack(
                [
                    tf_buf.lookup(o_frame, b_frame, s).planar()
                    for s in stamps
                ]
            ).astype(np.float32)
            base_frame = base_frame or b_frame

    wz = np.zeros(t, np.float32)
    if imus:
        it = np.array([m["stamp"] for m in imus])
        iw = np.array([m["w"][2] for m in imus])
        wz = np.interp(stamps, it, iw).astype(np.float32)
    elif odoms:
        ot = np.array([o["stamp"] for o in odoms])
        ow = np.array([o["angular"][2] for o in odoms])
        wz = np.interp(stamps, ot, ow).astype(np.float32)

    # export the static frame tree when it can resolve the laser extrinsic
    frames = None
    if base_frame is None:
        edge = _detect_odom_edge(tf_buf, laser_frame, None, odom_frame)
        if edge is not None:
            base_frame = edge[1]
    if base_frame is not None and (
        laser_frame == base_frame
        or tf_buf.static_connected(base_frame, laser_frame)
    ):
        frames = tf_buf.static_frame_tree(base_frame)

    return ScanLog(
        ranges=ranges,
        stamps=stamps,
        odom=odom_out,
        imu_wz=wz,
        angle_min=float(first["angle_min"]),
        angle_increment=float(first["angle_increment"]),
        range_min=float(first["range_min"]),
        range_max=float(first["range_max"]),
        time_increment=float(first["time_increment"]),
        laser_frame=laser_frame,
        frames=frames,
    )


# --------------------------------------------------------------------------
# minimal writer (fixtures / tests)


def _field(name: str, value: bytes) -> bytes:
    f = name.encode() + b"=" + value
    return struct.pack("<I", len(f)) + f


def _record(fields: dict[str, bytes], payload: bytes) -> bytes:
    header = b"".join(_field(k, v) for k, v in fields.items())
    return (
        struct.pack("<I", len(header))
        + header
        + struct.pack("<I", len(payload))
        + payload
    )


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def string(self, s: str):
        b = s.encode()
        self.out += struct.pack("<I", len(b)) + b

    def header(self, seq: int, stamp: float, frame: str):
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        self.out += struct.pack("<III", seq, secs, nsecs)
        self.string(frame)


def serialize_laser_scan(
    stamp: float,
    ranges,
    angle_min: float,
    angle_increment: float,
    range_min: float = 0.0,
    range_max: float = 100.0,
    time_increment: float = 0.0,
    frame: str = "laser",
) -> bytes:
    w = _Writer()
    w.header(0, stamp, frame)
    r = np.asarray(ranges, np.float32)
    angle_max = angle_min + angle_increment * (len(r) - 1)
    w.out += struct.pack(
        "<7f",
        angle_min,
        angle_max,
        angle_increment,
        time_increment,
        len(r) * time_increment,
        range_min,
        range_max,
    )
    w.out += struct.pack("<I", len(r)) + r.tobytes()
    w.out += struct.pack("<I", 0)  # intensities
    return bytes(w.out)


def serialize_odometry(
    stamp: float, pose, angular_z: float = 0.0, frame: str = "odom"
) -> bytes:
    w = _Writer()
    w.header(0, stamp, frame)
    w.string("base_link")
    x, y, yaw = (float(v) for v in pose)
    w.out += struct.pack("<3d", x, y, 0.0)
    w.out += struct.pack(
        "<4d", 0.0, 0.0, math.sin(yaw / 2.0), math.cos(yaw / 2.0)
    )
    w.out += np.zeros(36, "<f8").tobytes()
    w.out += struct.pack("<6d", 0.0, 0.0, 0.0, 0.0, 0.0, angular_z)
    w.out += np.zeros(36, "<f8").tobytes()
    return bytes(w.out)


def serialize_tf_message(
    transforms: list[tuple[float, str, str, tuple, tuple]],
) -> bytes:
    """tf2_msgs/TFMessage: (stamp, parent, child, xyz, quat_xyzw) tuples."""
    w = _Writer()
    w.out += struct.pack("<I", len(transforms))
    for stamp, parent, child, xyz, quat in transforms:
        w.header(0, stamp, parent)
        w.string(child)
        w.out += struct.pack("<3d", *(float(v) for v in xyz))
        w.out += struct.pack("<4d", *(float(v) for v in quat))
    return bytes(w.out)


def quat_from_rpy(roll: float, pitch: float, yaw: float) -> tuple:
    """(x, y, z, w) from intrinsic ZYX Euler angles (tf convention)."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return (
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    )


def serialize_imu(stamp: float, w_xyz, frame: str = "imu") -> bytes:
    w = _Writer()
    w.header(0, stamp, frame)
    w.out += np.array([0, 0, 0, 1], "<f8").tobytes()  # orientation
    w.out += np.zeros(9, "<f8").tobytes()
    w.out += np.asarray(w_xyz, "<f8").tobytes()
    w.out += np.zeros(9, "<f8").tobytes()
    w.out += np.zeros(3, "<f8").tobytes()
    w.out += np.zeros(9, "<f8").tobytes()
    return bytes(w.out)


def write_bag(
    path,
    messages: list[tuple[str, str, float, bytes]],
    compression: str = "none",
) -> None:
    """Write a minimal spec-conformant rosbag v2.0.

    messages: (topic, msg_type, time, serialized_body) tuples."""
    topics: dict[str, int] = {}
    chunk = bytearray()
    for topic, mtype, _, _ in messages:
        if topic in topics:
            continue
        conn = len(topics)
        topics[topic] = conn
        conn_header = _field("topic", topic.encode()) + _field(
            "type", mtype.encode()
        ) + _field("md5sum", b"*") + _field("message_definition", b"")
        chunk += _record(
            {
                "op": bytes([OP_CONNECTION]),
                "conn": struct.pack("<I", conn),
                "topic": topic.encode(),
            },
            conn_header,
        )
    for topic, _, t, body in messages:
        secs = int(t)
        nsecs = int(round((t - secs) * 1e9))
        chunk += _record(
            {
                "op": bytes([OP_MSG_DATA]),
                "conn": struct.pack("<I", topics[topic]),
                "time": struct.pack("<II", secs, nsecs),
            },
            body,
        )
    payload = bytes(chunk)
    if compression == "bz2":
        comp_payload = bz2.compress(payload)
    elif compression == "lz4":
        from tpuslam_torch.io import _lz4

        comp_payload = _lz4.compress(payload)
    elif compression == "none":
        comp_payload = payload
    else:
        raise ValueError(f"unsupported writer compression {compression!r}")

    out = bytearray(_VERSION_LINE)
    # bag header record, padded to 4096 bytes with spaces (spec)
    bh = _record(
        {
            "op": bytes([OP_BAG_HEADER]),
            "index_pos": struct.pack("<Q", 0),
            "conn_count": struct.pack("<I", len(topics)),
            "chunk_count": struct.pack("<I", 1),
        },
        b" " * 4096,
    )
    out += bh
    out += _record(
        {
            "op": bytes([OP_CHUNK]),
            "compression": compression.encode(),
            "size": struct.pack("<I", len(payload)),
        },
        comp_payload,
    )
    Path(path).write_bytes(bytes(out))
