"""``python -m tpuslam_torch.cli`` on the CPU, against ``tpuslam.cli``.

Each subcommand runs in a subprocess with ``--device cpu``, as
tests/test_cli.py runs the JAX CLI, with that file's bounds.  The
deterministic commands (synth, scan-info, pointcloud, features,
occupancy-map, undistort) run through the JAX CLI too, in this process,
on the same synthesized log: their JSON lines are equal, the ``.tslg``
bytes, corner masks and maps bit for bit, and the points within
ATOL_M = 1e-5 m (PyTorch's cos and sin against glibc's, ranges <= 30 m).
Karto through the CLI is ``slow`` as test_karto_cmd is, but for one short
case (a YAML config, the map stream and ``--save``).
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
ATOL_M = 1e-5


def run_cli(*args, stderr=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "tpuslam_torch.cli", *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return (res, out.stderr) if stderr else res


@pytest.fixture(scope="module")
def jax_cli():
    """``tpuslam.cli.main`` in this process (JAX on the CPU, no persistent
    compile cache), returning the JSON line it prints."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSLAM_NO_COMPILE_CACHE", "1")
        from tpuslam import cli

    def run(*args):
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(list(args))
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    return run


def test_synth_equals_jax(tmp_path, jax_cli):
    pt, pj = tmp_path / "port.tslg", tmp_path / "jax.tslg"
    args = ("--num-scans", "8", "--num-beams", "64", "--synthetic")
    r = run_cli("synth", "--out", str(pt), *args)
    assert r["scans"] == 8 and r["beams"] == 64
    want = jax_cli("synth", "--out", str(pj), *args)
    assert {**r, "written": None} == {**want, "written": None}
    assert pt.read_bytes() == pj.read_bytes()
    np.testing.assert_array_equal(np.load(f"{pt}.truth.npz")["true"],
                                  np.load(f"{pj}.truth.npz")["true"])
    info = run_cli("scan-info", "--log", str(pt))
    assert info == jax_cli("scan-info", "--log", str(pj))
    assert info["scans"] == 8 and info["num_beams"] == 64
    assert info["mean_valid_beams"] > 0 and info["mean_range"] > 0


# (command, arguments, saved arrays compared exactly, within ATOL_M)
DETERMINISTIC = {
    "pointcloud": (("--num-scans", "3", "--num-beams", "60"), ("valid",),
                   ("points",)),
    "features": (("--num-scans", "4", "--num-beams", "120"),
                 ("corner_masks",), ()),
    "occupancy-map": (("--num-scans", "6", "--num-beams", "180"), ("map",),
                      ()),
    "undistort": (("--num-scans", "4", "--num-beams", "90", "--distorted"),
                  (), ("points",)),
}


@pytest.mark.parametrize("cmd", sorted(DETERMINISTIC))
def test_deterministic_command_equals_jax(tmp_path, jax_cli, cmd):
    args, exact, close = DETERMINISTIC[cmd]
    st, sj = tmp_path / "port.npz", tmp_path / "jax.npz"
    got = run_cli(cmd, "--synthetic", *args, "--save", str(st))
    want = jax_cli(cmd, "--synthetic", *args, "--save", str(sj))
    assert got == want
    zt, zj = np.load(st), np.load(sj)
    assert sorted(zt.files) == sorted(zj.files) == sorted(exact + close)
    for k in exact:
        assert zt[k].dtype == zj[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    for k in close:
        np.testing.assert_allclose(zt[k], zj[k], rtol=0, atol=ATOL_M,
                                   err_msg=k)
    # test_cli.py's assertions
    if cmd == "pointcloud":
        assert got["mean_valid"] > 0 and zt["points"].shape == (3, 60, 2)
    elif cmd == "features":
        assert got["workload"] == "features" and got["mean_corners"] >= 0
    elif cmd == "occupancy-map":
        assert got["occupied_cells"] > 0 and got["free_cells"] > 0
    else:
        assert got["scans"] == 3 and zt["points"].shape == (3, 90, 2)


def test_icp_cmd(tmp_path):
    save = tmp_path / "icp.npz"
    r = run_cli("scan-match-icp", "--synthetic", "--num-scans", "4",
                "--num-beams", "180", "--save", str(save))
    assert r["workload"] == "scan_match_icp" and r["frames"] == 4
    assert np.load(save)["transforms"].shape == (4, 3)


def test_plicp_cmd(tmp_path):
    save = tmp_path / "out.npz"
    r = run_cli("plicp-odometry", "--synthetic", "--num-scans", "10",
                "--num-beams", "180", "--save", str(save))
    assert r["ate_rmse"] is not None and r["ate_rmse"] < 0.1
    assert np.load(save)["poses"].shape == (10, 3)


def test_hector_cmd(tmp_path):
    save, png = tmp_path / "h.npz", tmp_path / "m.png"
    r = run_cli("hector", "--synthetic", "--num-scans", "12",
                "--num-beams", "240", "--poses-per-rev", "120",
                "--save", str(save), "--png", str(png))
    assert r["ate_rmse"] < 0.1, r
    z = np.load(save)
    assert z["map"].ndim == 2 and z["poses"].shape == (12, 3)
    assert png.exists() and png.stat().st_size > 5000


def test_hector_undistort_cmd():
    r = run_cli("hector", "--synthetic", "--distorted", "--undistort",
                "--num-scans", "10", "--num-beams", "240",
                "--poses-per-rev", "120")
    assert r["ate_rmse"] < 0.12, r


def test_karto_yaml_config_map_stream_and_save(tmp_path):
    """The short Karto case: test_cli.py's YAML config, plus the map stream
    (map_update events on stderr) and the saved poses and map."""
    cfgfile = tmp_path / "mapper.yaml"
    cfgfile.write_text(
        "use_scan_range: 6.0\n"
        "minimum_travel_distance: 0.2\n"
        "scan_buffer_size: 10\n"
        "correlation_search_space_dimension: 0.32\n"
        "correlation_search_space_resolution: 0.02\n"
        "correlation_search_space_smear_deviation: 0.04\n"
        "do_loop_closing: false\n"
    )
    save = tmp_path / "k.npz"
    r, err = run_cli("karto", "--synthetic", "--num-scans", "8",
                     "--num-beams", "120", "--config", str(cfgfile),
                     "--map-stream", "0.3", "--save", str(save), stderr=True)
    assert r["scans_processed"] >= 3 and r["ate_rmse"] is not None
    z = np.load(save)
    assert z["poses"].shape == (r["scans_processed"], 3)
    assert (z["map"] == 100).sum() > 0
    events = [json.loads(line) for line in err.splitlines()
              if line.startswith('{"event"')]
    assert events and all(e["event"] == "map_update" for e in events)


@pytest.mark.slow
def test_karto_cmd():
    r = run_cli("karto", "--synthetic", "--num-scans", "20",
                "--num-beams", "180")
    assert r["scans_processed"] > 5
    assert r["ate_rmse"] is not None and r["ate_rmse"] < 0.15


@pytest.mark.slow
def test_karto_laser_mount(tmp_path):
    """test_cli.py: an upright mount at the origin changes nothing; an
    inverted laser's reversed ranges are restored by its mount."""
    import dataclasses

    from tpuslam_torch.io import bag

    common = ("--synthetic", "--num-scans", "12", "--num-beams", "180",
              "--seed", "3")
    r_plain = run_cli("karto", *common)
    r_id = run_cli("karto", *common, "--laser-mount", "0,0,0.3,0,0,0")
    assert r_id["scans_processed"] == r_plain["scans_processed"]
    assert abs(r_id["ate_rmse"] - r_plain["ate_rmse"]) < 1e-9
    log, true = bag.synthesize(num_scans=12, num_beams=180, seed=3,
                               poses_per_rev=40)
    p = tmp_path / "inv.npz"
    bag.save_npz(p, dataclasses.replace(log,
                                        ranges=log.ranges[:, ::-1].copy()))
    save = tmp_path / "poses.npz"
    run_cli("karto", "--log", str(p), "--save", str(save),
            "--laser-mount", "0,0,0.3,3.14159265358979,0,0")
    poses = np.load(save)["poses"]
    n = poses.shape[0]
    assert n == r_plain["scans_processed"]
    assert np.sqrt(((poses[:, :2] - true[:n, :2]) ** 2).sum(1)).mean() < 0.2


@pytest.mark.slow
def test_karto_tf_only_bag(tmp_path):
    """test_cli.py: a bag with odometry only on /tf replays like the
    /odom-topic bag; an inverted laser declared in /tf_static alone is
    restored through the bag's frame tree."""
    import math

    import test_rosbag_real as trr

    from tpuslam_torch.io import bag

    log, true = bag.synthesize(num_scans=12, num_beams=180, seed=3,
                               poses_per_rev=40)
    kw = dict(angle_min=log.angle_min, inc=log.angle_increment,
              rmin=log.range_min, rmax=log.range_max)
    pa, pb, pc = (tmp_path / f"{x}.bag" for x in "abc")
    trr.write_roscomm_style_bag(pa, trr._tf_bag_messages(
        log.stamps, log.odom, log.ranges, with_odom_topic=True, **kw))
    trr.write_roscomm_style_bag(pb, trr._tf_bag_messages(
        log.stamps, log.odom, log.ranges, with_odom_topic=False,
        static_tfs=trr._IDENT_LASER, **kw))
    trr.write_roscomm_style_bag(pc, trr._tf_bag_messages(
        log.stamps, log.odom, log.ranges[:, ::-1].copy(),
        with_odom_topic=False,
        static_tfs=[("base_link", "laser_frame", (0.0, 0.0, 0.3),
                     trr._quat_roll(math.pi))], **kw))
    sa, sb, sc = (tmp_path / f"{x}.npz" for x in "abc")
    ra = run_cli("karto", "--log", str(pa), "--save", str(sa))
    rb = run_cli("karto", "--log", str(pb), "--save", str(sb))
    assert rb["scans_processed"] == ra["scans_processed"] > 0
    np.testing.assert_allclose(np.load(sb)["poses"], np.load(sa)["poses"],
                               atol=1e-5)
    run_cli("karto", "--log", str(pc), "--save", str(sc))
    poses = np.load(sc)["poses"]
    n = poses.shape[0]
    assert n == ra["scans_processed"]
    assert np.sqrt(((poses[:, :2] - true[:n, :2]) ** 2).sum(1)).mean() < 0.2


@pytest.mark.slow
def test_karto_undistort_improves_ate():
    common = ("--synthetic", "--distorted", "--num-scans", "24",
              "--num-beams", "180", "--poses-per-rev", "30")
    raw = run_cli("karto", *common)
    fix = run_cli("karto", *common, "--undistort")
    assert raw["scans_processed"] > 5 and fix["scans_processed"] > 5
    assert fix["ate_rmse"] < raw["ate_rmse"], (raw, fix)
    assert fix["ate_rmse"] < 0.08, fix
