"""tpuslam_torch command line: the six lesson workloads as subcommands,
counterpart of ``tpuslam/cli.py`` (same subcommands, flags, JSON keys and
``--save`` arrays), on the port's engines:

    synth            generate a synthetic scan log (.tslg / .npz)
    scan-info        lesson1: scan stream metadata/statistics
    features         lesson1: curvature corner extraction
    pointcloud       lesson2: scan→point-cloud conversion dump
    scan-match-icp   lesson2: frame-to-frame ICP
    plicp-odometry   lesson3: PL-ICP keyframe odometry
    occupancy-map    lesson4: gmapping-style hit/visit map from posed scans
    hector           lesson4: hector SLAM (--png renders map+trajectory)
    undistort        lesson5: IMU/odom motion-distortion correction
    karto            lesson6: correlative frontend + loop closure + solver

    python -m tpuslam_torch.cli karto --log run.bag --save out.npz
    python -m tpuslam_torch.cli karto --synthetic --device cpu

Every workload runs from a scan log (``--log``: .tslg, .npz or a ROS1
.bag) or a synthesized one (``--synthetic``), prints a JSON result line,
and can save outputs with ``--save out.npz``.  ``--device`` (default
``cuda``) is where every engine places its state and runs; a command
given ``cuda`` on a machine without a CUDA device exits with an error
(pass ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

# commands that touch no device: the log and its statistics are NumPy
_HOST_ONLY = ("synth", "scan-info")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--log",
        help="scan log path (.tslg, .npz, or a ROS1 .bag — chunk "
        "compression none/bz2/lz4)",
    )
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic log instead of --log")
    p.add_argument("--distorted", action="store_true",
                   help="with --synthetic: simulate rolling-shutter motion "
                   "distortion (beams cast from the poses swept during "
                   "acquisition) — the effect --undistort corrects")
    p.add_argument("--num-scans", type=int, default=60)
    p.add_argument("--poses-per-rev", type=int, default=40,
                   help="synthetic circle density (scan-to-scan motion)")
    p.add_argument("--num-beams", type=int, default=360)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", help="write outputs (npz)")
    p.add_argument("--png", help="render map/trajectory PNG (rviz analog)")
    p.add_argument("--map-stream", type=float, metavar="SECONDS",
                   help="publish map_update events every SECONDS of scan "
                   "time (reference: map_update_interval 5s / "
                   "map_pub_period 2s); summaries log to stderr")
    p.add_argument("--config", help="YAML config with reference parameter "
                   "names (core.config.from_yaml)")
    p.add_argument("--report", action="store_true",
                   help="print per-stage timing report to stderr")
    p.add_argument("--laser-mount", metavar="X,Y,Z,ROLL,PITCH,YAW",
                   help="static base_link->laser extrinsic (the reference "
                   "looks this up from TF, karto_slam.cc:327-405 / "
                   "plicp_odometry.cc:257-280); upside-down mounts "
                   "(|roll| ~ pi) are auto-detected and their range arrays "
                   "reversed, karto_slam.cc:417-425")
    p.add_argument("--undistort", action="store_true",
                   help="run lesson5's gyro/odometry motion correction on "
                   "every scan before matching — the reference's node "
                   "chain, lidar_undistortion.launch feeding the matcher "
                   "(lidar_undistortion.cc:339-447); needs per-beam "
                   "stamps (a log with time_increment > 0) to have any "
                   "effect")
    p.add_argument("--device", default="cuda",
                   help="torch device every engine runs on (default cuda; "
                   "cpu for a machine without a card)")


def _laser_registry(args, log=None):
    """Build the FrameTree/LaserRegistry for --laser-mount (or None).

    Returns (registry, frame_name); the caller composes sensor poses via
    ``registry.sensor_pose`` and stages ranges via ``stage_ranges``.  When
    no --laser-mount is given but the log came from a rosbag carrying
    /tf_static, the extrinsic resolves from the bag's own frame tree
    (io/rosbag.py TfBuffer), as SlamKarto::getLaser looks it up
    (karto_slam.cc:327-405)."""
    from tpuslam_torch.core.frames import FrameTree, LaserRegistry, Transform3

    if getattr(args, "laser_mount", None):
        vals = [float(x) for x in args.laser_mount.split(",")]
        if len(vals) != 6:
            raise SystemExit("--laser-mount needs 6 comma-separated values")
        ft = FrameTree("base_link")
        ft.add("base_link", "laser", Transform3.from_xyz_rpy(*vals))
        return LaserRegistry(ft), "laser"
    frames = getattr(log, "frames", None)
    laser_frame = getattr(log, "laser_frame", None)
    if frames is not None and laser_frame and laser_frame != frames.root:
        return LaserRegistry(frames), laser_frame
    return None, None


def _odom_rel(log, i: int) -> np.ndarray:
    """Odometric motion from scan i to scan i + 1 in scan i's frame."""
    a, b = log.odom[i], log.odom[i + 1]
    ca, sa = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([
        ca * d[0] + sa * d[1],
        -sa * d[0] + ca * d[1],
        np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2])),
    ])


def _undistort_args(log, i: int, device):
    """lesson5's inputs for scan i: a gyro buffer of the log's yaw rate
    over [stamps[i], stamps[i+1]] and the odometric motion over it.  Scan
    i's beams sweep forward from its stamp (beam-0 frame = the pose at
    stamps[i]), so the bracket is the next sample's (offline replay has
    it; the reference node buffers until TF covers the sweep,
    lidar_undistortion.cc:250-312).

    The times are rebased on scan i's stamp here, in f64, before any f32
    cast: (t0, t1) = (0, stamps[i+1] - stamps[i]).  A bag stamps in
    seconds since 1970, where f32 would round every beam time to t0."""
    from tpuslam_torch.models.undistort import make_imu_buffer

    t1 = float(log.stamps[i + 1]) - float(log.stamps[i])
    imu = make_imu_buffer(np.array([0.0, t1]),
                          np.array([log.imu_wz[i + 1]] * 2), 64,
                          device=device)
    rel = torch.as_tensor(_odom_rel(log, i), dtype=torch.float32,
                          device=device)
    return imu, rel, 0.0, t1


def _make_undistorter(args, log):
    """Per-scan motion corrector for --undistort (or None):
    ``fn(i, scan) -> Scan`` applies lesson5's correction with the log's
    own gyro + odometry, chained in front of the matcher as the
    reference's launch graph chains the node (lidar_undistortion.launch).
    The last scan passes through uncorrected."""
    if not getattr(args, "undistort", False):
        return None
    from tpuslam_torch.core.config import UndistortConfig
    from tpuslam_torch.models.undistort import undistorted_scan

    cfg = UndistortConfig()

    def fn(i, scan):
        if i + 1 >= len(log):
            return scan  # no bracketing sample after the final scan
        return undistorted_scan(cfg, scan,
                                *_undistort_args(log, i, args.device))

    return fn


def _get_log(args):
    from tpuslam_torch.io import bag

    if args.log:
        return bag.load(args.log), None
    log, true = bag.synthesize(
        num_scans=args.num_scans, num_beams=args.num_beams, seed=args.seed,
        poses_per_rev=args.poses_per_rev,
        distorted=getattr(args, "distorted", False),
    )
    return log, true


def _ate(poses: np.ndarray, true: np.ndarray | None):
    if true is None:
        return None
    n = min(len(poses), len(true))
    return float(
        np.sqrt(((poses[:n, :2] - true[:n, :2]) ** 2).sum(1)).mean()
    )


def _emit(payload: dict, save: str | None, arrays: dict | None = None):
    print(json.dumps(payload))
    if save and arrays:
        np.savez_compressed(save, **arrays)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def cmd_synth(args):
    from tpuslam_torch.io import bag

    log, true = bag.synthesize(
        num_scans=args.num_scans, num_beams=args.num_beams, seed=args.seed,
        poses_per_rev=args.poses_per_rev,
    )
    out = args.out
    if out.endswith(".npz"):
        bag.save_npz(out, log)
    else:
        bag.save_tslg(out, log)
    np.savez_compressed(out + ".truth.npz", true=true)
    print(json.dumps({"written": out, "scans": len(log),
                      "beams": log.num_beams}))


def cmd_scan_info(args):
    """Lesson1 laser_scan_node parity: print scan metadata + per-scan stats
    (reference: lesson1/src/laser_scan_node.cc:49-74)."""
    log, _ = _get_log(args)
    finite = np.isfinite(log.ranges) & (log.ranges > 0)
    _emit(
        {
            "workload": "scan_info",
            "scans": len(log),
            "num_beams": log.num_beams,
            "angle_min": log.angle_min,
            "angle_increment": log.angle_increment,
            "range_min": log.range_min,
            "range_max": log.range_max,
            "time_increment": log.time_increment,
            "mean_valid_beams": float(finite.sum(1).mean()),
            "mean_range": float(log.ranges[finite].mean()),
            "duration_s": float(log.stamps[-1] - log.stamps[0]),
        },
        args.save,
    )


def cmd_pointcloud(args):
    """Lesson2 scan→cloud converter parity (scan_to_pointclod2_converter.cc:
    52-81): polar→cartesian with validity gating, dumped as npz."""
    from tpuslam_torch.core.scan import scan_to_points

    log, _ = _get_log(args)
    pts, valid = scan_to_points(log.scans_batched(device=args.device))
    valid = _host(valid)
    _emit(
        {"workload": "pointcloud", "scans": len(log),
         "mean_valid": float(valid.sum(1).mean())},
        args.save,
        {"points": _host(pts), "valid": valid},
    )


# scans a features call takes at once
_FEATURE_CHUNK = 256


def cmd_features(args):
    from tpuslam_torch.core.config import FeatureConfig
    from tpuslam_torch.core.scan import Scan
    from tpuslam_torch.ops.features import extract_features

    log, _ = _get_log(args)
    cfg = FeatureConfig()
    scans = log.scans_batched(device=args.device)
    masks = np.concatenate([
        _host(extract_features(cfg, Scan(
            *(f[a: a + _FEATURE_CHUNK] for f in scans))).corner_mask)
        for a in range(0, len(log), _FEATURE_CHUNK)
    ])
    _emit(
        {"workload": "features", "scans": len(log),
         "mean_corners": float(np.mean(masks.sum(1)))},
        args.save,
        {"corner_masks": masks},
    )


def cmd_icp(args):
    from tpuslam_torch.core.config import IcpConfig
    from tpuslam_torch.models import scan_match_icp

    log, _ = _get_log(args)
    cfg = IcpConfig(num_beams=log.num_beams, max_iterations=20)
    st = scan_match_icp.init_state(cfg, device=args.device)
    out = []
    for i in range(len(log)):
        st, res = scan_match_icp.step(cfg, st, log.scan(i,
                                                        device=args.device))
        out.append(res.pose)
    out = _host(torch.stack(out))
    _emit(
        {"workload": "scan_match_icp", "frames": len(log),
         "mean_step_norm": float(np.linalg.norm(out[1:, :2], axis=1).mean())},
        args.save,
        {"transforms": out},
    )


def cmd_plicp(args):
    from tpuslam_torch.core import se2
    from tpuslam_torch.core.config import PlicpConfig
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.models import plicp_odometry
    from tpuslam_torch.utils.timing import StepTimer

    dev = args.device
    log, true = _get_log(args)
    cfg = PlicpConfig(num_beams=log.num_beams)
    st = plicp_odometry.init_state(cfg, device=dev)
    # --laser-mount: the model consumes the planar base->laser extrinsic
    # directly (plicp_odometry.cc:257-280 TF chain); inverted mounts also
    # reverse the range arrays at staging (karto_slam.cc:417-425)
    registry, laser_frame = _laser_registry(args, log)
    b2l = None
    if registry is not None:
        b2l = torch.as_tensor(registry.get(laser_frame).offset_pose,
                              dtype=torch.float32, device=dev)

    def _scan(i):
        if registry is None:
            return log.scan(i, device=dev)
        return make_scan(
            registry.stage_ranges(laser_frame, log.ranges[i]),
            angle_min=log.angle_min, angle_increment=log.angle_increment,
            range_min=log.range_min, range_max=log.range_max,
            time_increment=log.time_increment, num_beams=log.num_beams,
            device=dev,
        )

    timer = StepTimer(device=dev)
    poses = []
    dts = np.diff(log.stamps, prepend=log.stamps[0] - 0.1)
    for i in range(len(log)):
        with timer.stage("plicp_step"):
            st, info = plicp_odometry.step(cfg, st, _scan(i),
                                           dt=float(dts[i]),
                                           base_to_laser=b2l)
        poses.append(info.pose)
    poses = _host(torch.stack(poses))
    # odometry is relative to the first pose's frame
    rel_true = None
    if true is not None:
        t = torch.as_tensor(true, dtype=torch.float32)
        rel_true = se2.relative(t[0], t).numpy()
    if args.report:
        print(timer.report(), file=sys.stderr)
    _emit(
        {"workload": "plicp_odometry", "scans": len(log),
         "ate_rmse": _ate(poses, rel_true)},
        args.save,
        {"poses": poses},
    )


def occupancy_config(log, poses: np.ndarray):
    """occupancy-map's GMapping configuration: a square 5 cm grid around
    the poses, half the lidar's range beyond them."""
    from tpuslam_torch.core.config import GmappingConfig

    span = float(np.abs(poses[:, :2]).max()) + log.range_max / 2 + 1
    return GmappingConfig(
        xmin=-span, ymin=-span, xmax=span, ymax=span, delta=0.05,
        num_beams=log.num_beams,
        ray_steps=int(log.range_max / 0.05) + 8,
    )


def cmd_occupancy(args):
    from tpuslam_torch.models import gmapping
    from tpuslam_torch.ops.counts import gmapping_export

    log, true = _get_log(args)
    poses = true if true is not None else log.odom
    cfg = occupancy_config(log, poses)
    counts = gmapping.map_from_scans(
        cfg, torch.as_tensor(poses, dtype=torch.float32, device=args.device),
        log.scans_batched(device=args.device),
    )
    img = _host(gmapping_export(counts, cfg.occ_thresh))
    _emit(
        {"workload": "occupancy_map", "scans": len(log),
         "occupied_cells": int((img == 100).sum()),
         "free_cells": int((img == 0).sum())},
        args.save,
        {"map": img},
    )


def _make_map_publisher(period, exporter):
    """MapPublisher wired to a stderr JSON sink (image elided from logs)."""
    from tpuslam_torch.utils.events import EventBus
    from tpuslam_torch.utils.map_server import MapPublisher

    bus = EventBus()

    def _sink(event, payload):
        rec = {k: (list(v) if isinstance(v, tuple) else v)
               for k, v in payload.items() if k != "image"}
        print(json.dumps({"event": event, **rec}), file=sys.stderr)

    bus.subscribe(_sink)
    return MapPublisher(bus, exporter, period=period)


def cmd_hector(args):
    from tpuslam_torch.core.config import HectorConfig
    from tpuslam_torch.models import hector_slam
    from tpuslam_torch.utils.timing import StepTimer

    dev = args.device
    log, true = _get_log(args)
    if args.config:
        from tpuslam_torch.core.config import from_yaml

        cfg = dataclasses.replace(from_yaml("hector", args.config),
                                  num_beams=log.num_beams)
    else:
        cfg = HectorConfig(
            map_size=512, num_beams=log.num_beams,
            laser_max_dist=min(log.range_max, 25.0),
            ray_steps=512,
            map_update_distance_thresh=0.1, map_update_angle_thresh=0.15,
        )
    undis = _make_undistorter(args, log)

    def scan(i):
        sc = log.scan(i, device=dev)
        return sc if undis is None else undis(i, sc)

    st = hector_slam.init_state(cfg, device=dev)
    if true is not None:
        st = st._replace(pose=torch.as_tensor(true[0], dtype=torch.float32,
                                              device=dev))
    st, _ = hector_slam.step(cfg, st, scan(0), map_without_matching=True)
    timer = StepTimer(device=dev)
    pub = None
    if getattr(args, "map_stream", None) is not None:
        # hector's map_pub_period publish thread analog
        # (hector_slam.cc:86, 253-317)
        pub = _make_map_publisher(
            args.map_stream, lambda: _host(hector_slam.occupancy_image(st))
        )
    poses = [st.pose]
    for i in range(1, len(log)):
        scan_i = scan(i)
        with timer.stage("hector_step"):
            st, res = hector_slam.step(cfg, st, scan_i)
        poses.append(st.pose)
        if pub is not None:
            pub.maybe_publish(float(log.stamps[i]))
    poses = _host(torch.stack(poses))
    if args.report:
        print(timer.report(), file=sys.stderr)
    img = _host(hector_slam.occupancy_image(st))
    if args.png:
        from tpuslam_torch.utils.viz import render_map

        spec = hector_slam.make_specs(cfg)[0]
        render_map(args.png, img, resolution=spec.resolution,
                   origin=(spec.origin_x, spec.origin_y), trajectory=poses,
                   title="hector")
    _emit(
        {"workload": "hector", "scans": len(log),
         "ate_rmse": _ate(poses, true),
         "map_updates": int(st.num_updates)},
        args.save,
        {"poses": poses, "map": img},
    )


def cmd_undistort(args):
    from tpuslam_torch.core.config import UndistortConfig
    from tpuslam_torch.models.undistort import undistort

    log, _ = _get_log(args)
    cfg = UndistortConfig()
    # scan i sweeps forward from its stamp; the bracket is [stamps[i],
    # stamps[i+1]] — the convention _make_undistorter uses too
    pts_all = [
        undistort(cfg, log.scan(i, device=args.device),
                  *_undistort_args(log, i, args.device))[0]
        for i in range(len(log) - 1)
    ]
    _emit(
        {"workload": "undistort", "scans": len(log) - 1,
         "num_beams": log.num_beams},
        args.save,
        {"points": _host(torch.stack(pts_all))},
    )


def cmd_karto(args):
    from tpuslam_torch.core.config import KartoConfig
    from tpuslam_torch.models.karto import KartoMapper

    log, true = _get_log(args)
    if args.config:
        from tpuslam_torch.core.config import from_yaml

        cfg = dataclasses.replace(from_yaml("karto", args.config),
                                  num_beams=log.num_beams)
    else:
        cfg = KartoConfig(
            num_beams=log.num_beams,
            use_scan_range=min(log.range_max, 12.0),
            scan_buffer_size=20,
            correlation_search_space_dimension=0.32,
            correlation_search_space_resolution=0.02,
            correlation_search_space_smear_deviation=0.04,
            loop_search_space_dimension=4.0,
            loop_search_space_resolution=0.1,
            loop_search_space_smear_deviation=0.1,
            loop_search_maximum_distance=1.5,
            loop_match_minimum_chain_size=4,
            loop_match_minimum_response_coarse=0.5,
            loop_match_minimum_response_fine=0.5,
        )
    mapper = KartoMapper(cfg, max_scans=max(64, len(log)),
                         device=args.device)
    return _run_karto(args, log, true, mapper)


def _run_karto(args, log, true, mapper):
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.models.karto import _np_compose, _np_inverse
    from tpuslam_torch.utils.timing import StepTimer

    dev = args.device
    registry, laser_frame = _laser_registry(args, log)
    undis = _make_undistorter(args, log)

    def stage(i):
        """Scan + sensor-frame odometry for scan i, honoring the laser
        extrinsic: inverted mounts reverse the range array
        (karto_slam.cc:417-425) and the odometric search center is the
        LASER's world pose, base ∘ offset (karto_slam.cc:381-405).
        --undistort corrects AFTER the extrinsic staging, matching the
        reference chain (the undistortion node consumes the mounted
        laser's frames)."""
        if registry is None:
            scan = log.scan(i, device=dev)
        else:
            scan = make_scan(
                registry.stage_ranges(laser_frame, log.ranges[i]),
                angle_min=log.angle_min,
                angle_increment=log.angle_increment,
                range_min=log.range_min, range_max=log.range_max,
                time_increment=log.time_increment, num_beams=log.num_beams,
                device=dev,
            )
        if undis is not None:
            scan = undis(i, scan)
        odom_i = (log.odom[i] if registry is None
                  else registry.sensor_pose(laser_frame, log.odom[i]))
        return scan, odom_i

    timer = StepTimer(device=dev)
    pub = None
    if getattr(args, "map_stream", None) is not None:

        def _export():
            g = mapper.occupancy_grid()
            return (_host(g[1]) if g is not None
                    else np.zeros((1, 1), np.int8))

        pub = _make_map_publisher(args.map_stream, _export)
    loops = 0
    kept_truth = []
    for i in range(len(log)):
        scan_i, odom_i = stage(i)
        with timer.stage("karto_process"):
            res = mapper.process(scan_i, odom_i,
                                 time=float(log.stamps[i]))
        if res.processed:
            loops += int(res.loop_closed)
            if true is not None:
                kept_truth.append(true[i])
            if pub is not None:
                pub.maybe_publish(float(log.stamps[i]))
    n = len(mapper.records)
    # mapper poses are LASER (sensor) poses; with a laser mount, convert
    # back to the base frame before comparing against the base ground
    # truth or saving
    out_poses = mapper.poses[:n].copy()
    if registry is not None:
        off = registry.get(laser_frame).offset_pose
        inv = _np_inverse(np.asarray(off, np.float64))
        out_poses = np.stack([_np_compose(p, inv) for p in out_poses])
    ate = None
    if kept_truth:
        kt = np.stack(kept_truth)[:n]
        ate = float(np.sqrt(((out_poses[:, :2] - kt[:, :2]) ** 2)
                            .sum(1)).mean())
    if args.report:
        print(timer.report(), file=sys.stderr)
    arrays = {"poses": out_poses}
    if args.save or args.png:
        grid = mapper.occupancy_grid()
        if grid is not None:
            arrays["map"] = _host(grid[1])
            if args.png:
                from tpuslam_torch.utils.viz import (
                    karto_graph_segments,
                    render_map,
                )

                render_map(
                    args.png, arrays["map"], resolution=grid[0].resolution,
                    origin=(grid[0].origin_x, grid[0].origin_y),
                    trajectory=mapper.poses[:n],
                    graph_edges=karto_graph_segments(mapper), title="karto",
                )
    _emit(
        {"workload": "karto", "scans_processed": n,
         "edges": len(mapper.edges), "loop_closures": loops,
         "ate_rmse": ate},
        args.save,
        arrays,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpuslam_torch",
                                 description="2D laser SLAM on PyTorch + "
                                 "CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synth", help="generate a synthetic scan log")
    p.add_argument("--out", required=True)
    _add_common(p)
    p.set_defaults(fn=cmd_synth)

    for name, fn in [
        ("scan-info", cmd_scan_info),
        ("pointcloud", cmd_pointcloud),
        ("features", cmd_features),
        ("scan-match-icp", cmd_icp),
        ("plicp-odometry", cmd_plicp),
        ("occupancy-map", cmd_occupancy),
        ("hector", cmd_hector),
        ("undistort", cmd_undistort),
        ("karto", cmd_karto),
    ]:
        p = sub.add_parser(name)
        _add_common(p)
        p.set_defaults(fn=fn)

    args = ap.parse_args(argv)
    if not args.log and not args.synthetic and args.cmd != "synth":
        ap.error("provide --log PATH or --synthetic")
    if (args.cmd not in _HOST_ONLY
            and torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error(f"--device {args.device}: no CUDA device here "
                 "(torch.cuda.is_available() is false); pass --device cpu "
                 "to run on the CPU")
    # warn (never silently ignore) when a common flag is set but the
    # selected workload does not consume it
    honored = {
        "map_stream": ("karto", "hector"),
        "laser_mount": ("karto", "plicp-odometry"),
        "config": ("karto", "hector"),
        "undistort": ("karto", "hector"),
        "png": ("karto", "hector"),
        "save": ("pointcloud", "features", "scan-match-icp",
                 "plicp-odometry", "occupancy-map", "hector", "undistort",
                 "karto"),
    }
    for flag, cmds in honored.items():
        if getattr(args, flag, None) and args.cmd not in cmds:
            print(f"warning: --{flag.replace('_', '-')} is only "
                  f"implemented for {', '.join(cmds)}; ignored for "
                  f"{args.cmd}", file=sys.stderr)
    args.fn(args)


if __name__ == "__main__":
    main()
