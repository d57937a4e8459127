"""The port's host data path against the JAX package's: frames, the scan
log codecs and the ROS1 bag reader and writer.

- ``core.frames``: every lookup, the inversion probe, staging and sensor
  poses of tests/test_frames.py, equal in both packages (the same NumPy
  code);
- ``.tslg``: the port's writer gives the JAX writer's bytes (its native
  codec where it builds, else its Python one), NaN/inf beams included,
  and each package reads the other's file into an equal log; ``.npz``
  (whose zip entries carry the write time) cross-loads with equal arrays;
- bags: the port's ``write_bag`` gives the JAX ``write_bag``'s bytes; a
  bag written by it and bags in ros_comm's layout
  (tests/test_rosbag_real.py's independent writer) read into equal
  ``ScanLog``s in both packages: ``/odom``, tf-only odometry, tf
  interpolation, a multi-hop ``/tf_static`` chain and an inverted laser.
  lz4 chunks need the system liblz4: without it that case skips, as the
  reference's test does;
- ``utils``: the map publisher fires the JAX one's events; the step
  timer counts, and ``device_trace`` writes a profiler trace.

Tolerance: none anywhere (bit for bit).
"""

import math

import numpy as np
import pytest
import test_rosbag_real as trr

from tpuslam.core import frames as jframes
from tpuslam.io import bag as jbag
from tpuslam.io import rosbag as jros
from tpuslam_torch.core import frames as tframes
from tpuslam_torch.io import _lz4
from tpuslam_torch.io import bag as tbag
from tpuslam_torch.io import rosbag as tros


def _frames_case(m, name):
    T = m.Transform3.from_xyz_rpy
    ft = m.FrameTree("base_link")
    if name == "chain":
        ft.add("base_link", "mast", T(0.1, 0.0, 0.5))
        ft.add("mast", "laser", T(0.2, 0.05, 0.1, yaw=math.pi / 2))
        return ft.planar("base_link", "laser"), ft.planar("laser",
                                                          "base_link")
    if name == "siblings":
        ft.add("base_link", "front", T(0.3, 0.0, 0.2))
        ft.add("base_link", "rear", T(-0.3, 0.0, 0.2, yaw=math.pi))
        return (ft.planar("front", "rear"),
                ft.lookup("rear", "front").apply([1.0, 2.0, 3.0]))
    if name == "upside_down":
        ft.add("base_link", "up", T(0.2, 0.0, 0.3))
        ft.add("base_link", "down", T(0.2, 0.0, 0.3, roll=math.pi))
        return ft.is_upside_down("up"), ft.is_upside_down("down")
    if name == "registry":
        ft.add("base_link", "laser", T(0.5, 0.1, 0.2, roll=math.pi,
                                       yaw=0.3))
        reg = m.LaserRegistry(ft)
        info = reg.get("laser")
        return (info.offset_pose, info.inverted,
                reg.stage_ranges("laser", np.arange(5.0)),
                reg.sensor_pose("laser", [1.0, 2.0, math.pi / 2]))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["chain", "siblings", "upside_down",
                                  "registry"])
def test_frames_equal_jax(name):
    got, want = _frames_case(tframes, name), _frames_case(jframes, name)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_frames_reject_unknown_and_cyclic():
    ft = tframes.FrameTree()
    with pytest.raises(KeyError):
        ft.lookup("base_link", "nope")
    with pytest.raises(ValueError):
        ft.add("orphan_parent", "child", tframes.Transform3.from_xyz_rpy())
    ft.add("base_link", "a", tframes.Transform3.from_xyz_rpy(1.0))
    with pytest.raises(ValueError):
        ft.add("base_link", "a", tframes.Transform3.from_xyz_rpy())


def _log(m, t=6, b=33):
    rng = np.random.default_rng(0)
    r = rng.uniform(0.5, 10, (t, b)).astype(np.float32)
    r[0, 1], r[0, 2], r[3, 5] = np.nan, np.inf, np.nan
    return m.ScanLog(
        ranges=r, stamps=100.0 + np.arange(t) * 0.1,
        odom=rng.uniform(-1, 1, (t, 3)).astype(np.float32),
        imu_wz=rng.uniform(-1, 1, t).astype(np.float32),
        angle_min=-1.5, angle_increment=0.01, range_min=0.1,
        range_max=30.0, time_increment=0.0001,
    )


LOG_FIELDS = ("ranges", "stamps", "odom", "imu_wz")
META_FIELDS = ("angle_min", "angle_increment", "range_min", "range_max",
               "time_increment")


def _logs_equal(a, b):
    for f in LOG_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in META_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def test_tslg_bytes_and_cross_loading(tmp_path):
    pj, pt = tmp_path / "jax.tslg", tmp_path / "port.tslg"
    jbag.save_tslg(pj, _log(jbag))
    tbag.save_tslg(pt, _log(tbag))
    assert pt.read_bytes() == pj.read_bytes()
    _logs_equal(tbag.load_tslg(pj), jbag.load_tslg(pj))
    _logs_equal(jbag.load_tslg(pt), tbag.load_tslg(pt))
    # the round trip: the arrays verbatim (NaN/inf too), the metadata as f32
    back, orig = tbag.load(pt), _log(tbag)
    for f in LOG_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(orig, f))
    for f in META_FIELDS:
        assert getattr(back, f) == float(np.float32(getattr(orig, f)))


def test_npz_cross_loading(tmp_path):
    pj, pt = tmp_path / "jax.npz", tmp_path / "port.npz"
    jbag.save_npz(pj, _log(jbag))
    tbag.save_npz(pt, _log(tbag))
    _logs_equal(tbag.load(pj), jbag.load(pj))
    _logs_equal(jbag.load(pt), tbag.load(pt))
    _logs_equal(tbag.load(pt), tbag.load(pj))


def test_synthesize_equals_jax():
    for distorted in (False, True):
        lt, tt = tbag.synthesize(num_scans=6, num_beams=45, seed=4,
                                 distorted=distorted)
        lj, tj = jbag.synthesize(num_scans=6, num_beams=45, seed=4,
                                 distorted=distorted)
        _logs_equal(lt, lj)
        np.testing.assert_array_equal(tt, tj)


def _messages(m):
    rng = np.random.default_rng(0)
    msgs = []
    for i in range(5):
        t = 100.0 + 0.1 * i
        r = rng.uniform(1.0, 5.0, 90).astype(np.float32)
        r[3] = np.inf
        msgs.append(("/scan", "sensor_msgs/LaserScan", t,
                     m.serialize_laser_scan(t, r, -1.57, 0.035,
                                            range_min=0.1, range_max=10.0,
                                            time_increment=1e-4)))
    for i in range(11):
        t = 99.95 + 0.05 * i
        pose = [0.1 * i, 0.02 * i, 0.01 * i]
        msgs.append(("/odom", "nav_msgs/Odometry", t,
                     m.serialize_odometry(t, pose, angular_z=0.2)))
        msgs.append(("/imu", "sensor_msgs/Imu", t,
                     m.serialize_imu(t, [0.0, 0.0, 0.3])))
    msgs.append(("/tf_static", "tf2_msgs/TFMessage", 100.0,
                 m.serialize_tf_message([(100.0, "base_link", "laser",
                                          (0.1, 0.0, 0.2),
                                          m.quat_from_rpy(0.0, 0.0, 0.1))])))
    return msgs


def _scanlogs_equal(a, b):
    _logs_equal(a, b)
    assert a.laser_frame == b.laser_frame
    assert (a.frames is None) == (b.frames is None)
    if a.frames is not None and a.laser_frame != a.frames.root:
        np.testing.assert_array_equal(
            a.frames.planar(a.frames.root, a.laser_frame),
            b.frames.planar(b.frames.root, b.laser_frame))
        assert (tframes.LaserRegistry(a.frames).get(a.laser_frame).inverted
                == jframes.LaserRegistry(b.frames).get(
                    b.laser_frame).inverted)


def _need_lz4(compression):
    if compression == "lz4" and not _lz4.available():
        pytest.skip("the system liblz4 is not available")


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_write_bag_bytes_and_scanlog(tmp_path, compression):
    _need_lz4(compression)
    pj, pt = tmp_path / "jax.bag", tmp_path / "port.bag"
    jros.write_bag(pj, _messages(jros), compression=compression)
    tros.write_bag(pt, _messages(tros), compression=compression)
    assert pt.read_bytes() == pj.read_bytes()
    back = tros.read_bag(pt)
    assert len(back) == len(_messages(tros))
    log = tros.bag_to_scanlog(pt)
    _scanlogs_equal(log, jros.bag_to_scanlog(pt))
    assert len(log) == 5 and np.isinf(log.ranges[0, 3])
    assert tbag.load(pt).ranges.shape == (5, 90)


def _roscomm_case(name, compression="none"):
    """(messages, msgs_per_chunk) of tests/test_rosbag_real.py's fixtures."""
    if name == "odom_imu":
        return trr._make_messages(), 4
    rng = np.random.default_rng(0)
    n, nb = 12, 24
    stamps = 50.0 + 0.1 * np.arange(n)
    poses = np.stack([0.08 * np.arange(n), 0.01 * np.arange(n),
                      0.03 * np.arange(n)], axis=-1)
    ranges = 2.0 + rng.uniform(0, 1, (n, nb))
    kw = dict(with_odom_topic=name == "odom_topic")
    if name == "tf_only":
        kw["static_tfs"] = trr._IDENT_LASER
    elif name == "tf_interpolated":
        kw.update(tf_stamps=stamps[0] - 0.05 + 0.1 * np.arange(n + 1),
                  tf_poses=np.stack([0.2 * np.arange(n + 1), np.zeros(n + 1),
                                     0.1 * np.arange(n + 1)], axis=-1),
                  static_tfs=trr._IDENT_LASER)
    elif name == "multi_hop":
        kw["static_tfs"] = [
            ("base_link", "mount", (0.3, 0.0, 0.1), trr._quat_yaw(0.2)),
            ("mount", "laser_frame", (0.1, 0.05, 0.0), trr._quat_yaw(0.3)),
        ]
    elif name == "inverted":
        kw["static_tfs"] = [("base_link", "laser_frame", (0.0, 0.0, 0.3),
                             trr._quat_roll(math.pi))]
        ranges = ranges[:, ::-1].copy()
    return trr._tf_bag_messages(stamps, poses, ranges, **kw), 4


@pytest.mark.parametrize("name", ["odom_topic", "tf_only", "tf_interpolated",
                                  "multi_hop", "inverted"])
def test_roscomm_bag_reads_equal(tmp_path, name):
    msgs, per_chunk = _roscomm_case(name)
    p = tmp_path / f"{name}.bag"
    trr.write_roscomm_style_bag(p, msgs, msgs_per_chunk=per_chunk)
    log = tros.bag_to_scanlog(p)
    _scanlogs_equal(log, jros.bag_to_scanlog(p))
    if name != "odom_topic":
        assert log.frames is not None and log.laser_frame == "laser_frame"
    if name == "inverted":
        reg = tframes.LaserRegistry(log.frames)
        assert reg.get(log.laser_frame).inverted
        np.testing.assert_array_equal(
            reg.stage_ranges(log.laser_frame, log.ranges[0]),
            log.ranges[0][::-1])


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_roscomm_chunks_read_equal(tmp_path, compression):
    """Multi-chunk ros_comm bags (connections repeated in the trailer,
    index and chunk-info records) in each chunk compression."""
    _need_lz4(compression)
    p = tmp_path / f"chunks_{compression}.bag"
    msgs = trr._make_messages()
    trr.write_roscomm_style_bag(p, msgs, compression=compression,
                                msgs_per_chunk=5)
    got, want = tros.read_bag(p), jros.read_bag(p)
    assert [(m.topic, m.msg_type, m.time, m.raw) for m in got] == [
        (m.topic, m.msg_type, m.time, m.raw) for m in want]
    assert len(got) == len(msgs)
    _scanlogs_equal(tros.bag_to_scanlog(p), jros.bag_to_scanlog(p))


def _published(events_mod, server_mod):
    """The events a MapPublisher fires over a stream of changing maps,
    with a backwards time jump."""
    bus, got = events_mod.EventBus(), []
    bus.subscribe(lambda ev, p: got.append(
        (ev, {k: v for k, v in p.items() if k != "image"})))
    imgs = [np.full((4, 5), -1, np.int8) for _ in range(6)]
    imgs[2][1, 2] = 100
    imgs[3][1:3, 0] = 0
    imgs[4] = np.zeros((3, 3), np.int8)  # a re-sized grid
    it = iter(imgs)
    pub = server_mod.MapPublisher(bus, lambda: next(it), period=1.0)
    fired = [pub.maybe_publish(t) for t in (0.0, 0.5, 1.2, 2.5, 3.4, 1.0)]
    return fired, got, pub.publishes


def test_map_publisher_equals_jax():
    from tpuslam.utils import events as jev
    from tpuslam.utils import map_server as jms
    from tpuslam_torch.utils import events as tev
    from tpuslam_torch.utils import map_server as tms

    assert _published(tev, tms) == _published(jev, jms)


def test_step_timer_and_device_trace(tmp_path):
    """A stage's count and time; ``device_trace`` writes a torch.profiler
    trace under its directory (nothing with None)."""
    import torch

    from tpuslam_torch.utils.timing import StepTimer, device_trace

    timer = StepTimer(device="cpu")
    for _ in range(3):
        with timer.stage("step"):
            torch.ones(8).sum()
    s = timer.stats["step"]
    assert s.count == 3 and 0.0 < s.max_s <= s.total_s
    assert "step" in timer.report() and s.rate_hz > 0
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert list((tmp_path / "trace").iterdir())


def test_corrupt_compression_raises(tmp_path):
    """A chunk whose compression field is not one the reader knows raises
    (tests/test_rosbag_real.py::test_lz4_chunk_requires_codec); a bag
    that is not rosbag v2.0 raises too."""
    p = tmp_path / "bad.bag"
    trr.write_roscomm_style_bag(p, trr._make_messages(n_scans=2))
    p.write_bytes(p.read_bytes().replace(b"compression=none",
                                         b"compression=lz4\x00"))
    with pytest.raises(ValueError, match="lz4"):
        tros.read_bag(p)
    q = tmp_path / "not_a_bag.bag"
    q.write_bytes(b"#ROSBAG V1.2\nxxxx")
    with pytest.raises(ValueError, match="not a rosbag v2.0"):
        tros.read_bag(q)
