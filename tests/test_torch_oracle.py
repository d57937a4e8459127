"""tpuslam_torch.oracle, the port against the f64 oracles, and the native
``.tslg`` codec.

(i) ``tpuslam_torch.oracle`` is the port's copy of ``tpuslam.oracle``:
    each of its modules gives the JAX package's outputs bit for bit
    (``np.array_equal`` on float64) on test_oracle_parity.py's fixtures at
    their sizes, its sources differ only in their imports, and it imports
    neither torch nor anything of JAX or of the JAX package.
(ii) The port against the oracles, for the contracts no other
    ``test_torch_*.py`` holds, each with test_oracle_parity.py's fixture and
    bound: the ``spa_solver`` solve (5e-4), ``KartoMapper`` sequential and
    through a loop closure (``test_pipeline_parity_*``'s bounds), GMapping's
    counters (bit for bit on the CPU), undistortion in its three cases
    (5e-5 m), ICP (2e-3 / 3e-3); and ``chip_smoke.py``'s phase 4o run
    here at 181 beams.
(iii) The native codec, built here with the host's ``c++``: its bytes equal
    the plain codec's and the JAX package's ``save_tslg``'s, loads through
    both codecs are equal, and a bad magic number or a truncated file
    raises in both.
"""

import dataclasses
import importlib
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpuslam.oracle as joracle
import tpuslam_torch.oracle as toracle
from tpuslam.core.config import KartoConfig as JKartoConfig
from tpuslam.graph import backends as jbackends
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.io import bag as jbag
from tpuslam.models.karto import KartoMapper as JKartoMapper
from tpuslam_torch.core.config import (
    GmappingConfig,
    HectorConfig,
    IcpConfig,
    UndistortConfig,
    outdoor_karto_config,
)
from tpuslam_torch.core.config import KartoConfig as TKartoConfig
from tpuslam_torch.core.scan import make_scan as _tmake_scan
from tpuslam_torch.core.scan import scan_to_points
from tpuslam_torch.graph.backends import graph_from_edges, make_solver
from tpuslam_torch.io import bag
from tpuslam_torch.io.simulate import rect_room, simulate_scan, world_with_boxes
from tpuslam_torch.match.icp import icp
from tpuslam_torch.models import gmapping, hector_slam
from tpuslam_torch.models import karto as karto_model
from tpuslam_torch.models.karto import KartoMapper, _np_compose, _np_inverse
from tpuslam_torch.models.undistort import make_imu_buffer, undistort
from tpuslam_torch.ops.bilinear import prob_from_log_odds

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODULES = ["__init__", "gmapping", "hector", "icp_pcl", "karto", "plicp",
           "spa2d", "undistort"]

# test_oracle_parity.py's Karto fixture: 120 beams in a room off the cell
# lattice, its configuration field for field
NB, THR = 120, 6.0
ROOM = rect_room(8.0614, 6.1402)
CFG_KW = dict(
    num_beams=NB, use_scan_range=THR, minimum_travel_distance=0.2,
    minimum_travel_heading=0.174, minimum_time_interval=3600.0,
    scan_buffer_size=20, scan_buffer_maximum_scan_distance=10.0,
    correlation_search_space_dimension=0.32,
    correlation_search_space_resolution=0.02,
    correlation_search_space_smear_deviation=0.04,
    loop_search_space_dimension=4.0, loop_search_space_resolution=0.1,
    loop_search_space_smear_deviation=0.1, loop_search_maximum_distance=1.5,
    loop_match_minimum_chain_size=4, loop_match_maximum_variance_coarse=0.4,
    loop_match_minimum_response_coarse=0.5,
    loop_match_minimum_response_fine=0.5,
    link_match_minimum_response_fine=0.6, link_scan_maximum_distance=1.5,
)
CFG = TKartoConfig(**CFG_KW)
# TestPlicpOracleParity / TestPclIcpOracleParity's scans
PAIR_WORLD = world_with_boxes(11.83, 9.41)
PAIR_NB = 240
RANGE_MIN, RANGE_MAX = 0.05, 19.0


def tmake_scan(*a, **kw):
    return _tmake_scan(*a, **kw, device="cpu")


def ranges_at(pose, world=ROOM, nb=NB):
    r, amin, ainc = simulate_scan(world, np.asarray(pose), num_beams=nb,
                                  max_range=30.0)
    return r, amin, ainc


def _same(a, b) -> bool:
    """Bit for bit: arrays (NaN where NaN), scalars and strings."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    return type(a) is type(b) and (a == b or (a != a and b != b))


# ------------------------------------------------------- (i) the copies


def _pair_scans(pose0, pose1, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    r0, amin, ainc = simulate_scan(PAIR_WORLD, np.asarray(pose0),
                                   num_beams=PAIR_NB, max_range=20.0,
                                   noise_std=noise, rng=rng)
    r1, _, _ = simulate_scan(PAIR_WORLD, np.asarray(pose1),
                             num_beams=PAIR_NB, max_range=20.0,
                             noise_std=noise, rng=rng)
    return r0, r1, amin, ainc


def _hector_grid(num_beams=181):
    """test_hector_gn_oracle_parity's map (the port's engine on the CPU):
    level 0's probabilities, the scan points in map cells and the first
    guess in map coordinates."""
    cfg = HectorConfig(map_size=256, map_resolution=0.05,
                       num_beams=num_beams, ray_steps=256)
    segs = rect_room(8.0614, 6.1402)

    def scan_at(pose):
        r, amin, ainc = simulate_scan(segs, pose, num_beams=num_beams,
                                      max_range=20.0, noise_std=0.004,
                                      rng=np.random.default_rng(17))
        return tmake_scan(r, angle_min=amin, angle_increment=ainc,
                          range_min=0.1, range_max=20.0, num_beams=num_beams)

    st = hector_slam.init_state(cfg, device="cpu")
    for p in [np.zeros(3), np.array([0.25, 0.15, 0.2]),
              np.array([-0.25, -0.15, -0.2])]:
        st = st._replace(pose=torch.tensor(p, dtype=torch.float32))
        st, _ = hector_slam.step(cfg, st, scan_at(p),
                                 map_without_matching=True)
    spec = hector_slam.make_specs(cfg)[0]
    true = np.array([0.07, -0.05, 0.06])
    pts, valid = scan_to_points(scan_at(true))
    pose0 = spec.world_pose_to_map(
        torch.tensor(true + [0.03, -0.02, 0.025], dtype=torch.float32))
    return (prob_from_log_odds(st.log_odds[0]).numpy(),
            (pts[valid] / np.float32(0.05)).numpy(),
            pose0.numpy().astype(np.float64))


def _undistort_fixture(n=180, wx=0.0, wy=0.0, wz=0.6, vel=(0.8, -0.4)):
    """TestUndistortOracleParity's scan, gyro samples and odometry."""
    period = 0.1
    t0, t1 = 0.0, period
    rng = np.random.default_rng(5)
    ranges = rng.uniform(2.0, 6.0, n)
    ranges[[3, 70]] = np.nan
    amin, inc = -np.pi / 2, np.pi / (n - 1)
    imu_t = np.concatenate([[t0 - 1e-5], np.linspace(t0, t1, 17)[1:],
                            [t1 + 0.01]])
    imu_w = np.tile([wx, wy, wz], (len(imu_t), 1))
    odom_t = [t0, t1, t1 + 0.02]
    odom_p = np.zeros((3, 6))
    for i, t in enumerate(odom_t):
        odom_p[i, :2] = np.asarray(vel) * (t - t0)
        odom_p[i, 5] = wz * period * (t - t0) / period
    odom_rel = np.array([vel[0] * period, vel[1] * period, wz * period])
    return dict(ranges=ranges, amin=amin, inc=inc, t0=t0, t1=t1,
                tinc=period / n, imu_t=imu_t, imu_w=imu_w, odom_t=odom_t,
                odom_p=odom_p, odom_rel=odom_rel)


def _undistort_oracle(ns, point_z, fx):
    orc = ns.OracleUndistorter(point_z=point_z)
    orc.prune_imu(fx["imu_t"], fx["imu_w"], fx["t0"], fx["t1"])
    orc.prune_odom(fx["odom_t"], fx["odom_p"], fx["t0"], fx["t1"])
    n = len(fx["ranges"])
    return orc.correct(fx["ranges"], fx["amin"] + np.arange(n) * fx["inc"],
                       0.1, 30.0, fx["t0"], fx["tinc"])


def _spa_circle():
    """test_spa2d_oracle_matches_tpu_solver's 24-node circle."""
    rng = np.random.default_rng(5)
    n = 24
    true = np.zeros((n, 3))
    for i in range(1, n):
        true[i] = _np_compose(true[i - 1], [0.5, 0.0, 2 * math.pi / n])
    noisy = true + rng.normal(0, [0.05, 0.05, 0.02], true.shape)
    noisy[0] = true[0]
    edges = [(i, i + 1, _rel(true[i], true[i + 1]),
              np.diag([50.0, 50.0, 100.0])) for i in range(n - 1)]
    for i, j in [(0, n - 1), (2, n - 3)]:
        edges.append((i, j, _rel(true[i], true[j]),
                      np.diag([200.0, 200.0, 400.0])))
    return noisy, edges


def _rel(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     math.atan2(math.sin(b[2] - a[2]), math.cos(b[2] - a[2]))])


def _run_module(name, ns, cfg_cls):
    """One module's outputs on its test_oracle_parity.py fixtures, through
    the oracle package ``ns`` (``cfg_cls``: that package's KartoConfig)."""
    mod = importlib.import_module(f"{ns.__name__}.{name}")
    if name == "__init__":
        return [list(ns.__all__)] + [getattr(ns, k).__name__
                                     for k in ns.__all__]
    if name == "gmapping":
        nb = 240
        rng = np.random.default_rng(7)
        angles = np.linspace(-np.pi, np.pi, nb, endpoint=False) + 0.0113
        ranges = rng.uniform(0.5, 11.5, nb)
        ranges[3:7] = [0.0, np.nan, 12.7, 6.0]
        om = mod.OracleGmappingMap(400, 400, 0.05, 0.0, 0.0)
        om.compute_map(ranges, np.cos(angles), np.sin(angles),
                       max_range=12.0, max_use_range=6.0)
        return [om.n, om.visits, om.occupancy()]
    if name == "hector":
        out = []
        om = mod.OracleHectorMap(48, 40)
        rng = np.random.default_rng(23)
        for step in range(4):
            pose = np.array([20.0 + step, 18.0 - step, 0.3 * step])
            pts = rng.uniform(-16, 16, (96, 2))
            pts[5] = [0.1, -0.2]
            pts[6] = pts[7]
            pts[8] = [35.0, 0.0]
            c, s = np.cos(pose[2]), np.sin(pose[2])
            world = (pts @ np.array([[c, s], [-s, c]]) + pose[:2]).astype(
                np.float32)
            om.update_by_scan_world(world, pose[:2].astype(np.float32))
            om.update_by_scan(pts, pose)
        out.append(om.grid())
        grid, pts_map, pose0 = _hector_grid()
        out.extend(mod.OracleHectorMatcher(grid).match(pose0, pts_map,
                                                       max_iterations=5))
        return out
    if name == "icp_pcl":
        out = []
        for p0, rel, holes in (((0.4, -0.2, 0.2), (0.05, -0.03, 0.02), False),
                               ((-0.5, 0.3, -0.8), (0.03, 0.02, -0.015),
                                True)):
            p1 = _np_compose(np.asarray(p0, float), np.asarray(rel, float))
            r0, r1, amin, ainc = _pair_scans(p0, p1, seed=3 if holes else 0)
            if holes:
                r0[10:25] = np.nan
                r1[100:115] = np.inf
            src = mod.convert_scan_to_cloud(r0, amin, ainc, RANGE_MIN,
                                            RANGE_MAX)
            tgt = mod.convert_scan_to_cloud(r1, amin, ainc, RANGE_MIN,
                                            RANGE_MAX)
            res = mod.OraclePclIcp().align(src, tgt)
            out += [src, res.transform, res.x, res.iterations, res.state,
                    res.converged]
        return out
    if name == "karto":
        cfg = cfg_cls(**CFG_KW)
        out = []
        rng = np.random.default_rng(3)
        bases = [(*ranges_at(bp), bp) for bp in
                 (np.zeros(3), np.array([0.2, 0.05, 0.05]),
                  np.array([0.45, 0.1, 0.1]))]
        true = np.array([0.62, 0.12, 0.12])
        qr, amin, ainc = ranges_at(true)
        om = mod.OracleScanMatcher(0.32, 0.02, 0.04, THR, cfg)
        for _ in range(3):
            center = true + rng.normal(0, [0.04, 0.04, 0.02])
            q = mod.OracleScan(qr, amin, ainc, range_threshold=THR,
                               minimum_range=0.1, odom_pose=center)
            bs = [mod.OracleScan(r, a, i, range_threshold=THR,
                                 minimum_range=0.1, odom_pose=bp)
                  for r, a, i, bp in bases]
            out += list(om.match_scan(q, bs, penalize=True, refine=True))
        rng = np.random.default_rng(17)
        mapper = mod.OracleMapper(cfg)
        true, odom = np.zeros(3), np.zeros(3)
        for _ in range(8):
            r, amin, ainc = ranges_at(true)
            sc = mod.OracleScan(r, amin, ainc, range_threshold=THR,
                                minimum_range=0.1, odom_pose=odom)
            out += [mapper.process(sc), sc.corrected_pose]
            step = np.array([0.25, 0.0, 0.12])
            true = _np_compose(true, step)
            odom = _np_compose(odom, step + rng.normal(0, [0.015, 0.015,
                                                           0.008]))
        return out
    if name == "plicp":
        out = []
        rng = np.random.default_rng(7)
        p0 = np.array([-0.8, 0.5, -1.1])
        p1 = _np_compose(p0, np.array([-0.09, 0.06, -0.04]))
        r0, r1, amin, ainc = _pair_scans(p0, p1, noise=0.004, seed=7)
        r0[rng.random(PAIR_NB) < 0.15] = np.nan
        r1[rng.random(PAIR_NB) < 0.15] = np.nan
        r1[40:48] = np.nan
        res = mod.OracleCsm(min_reading=RANGE_MIN,
                            max_reading=RANGE_MAX).sm_icp(
            mod.OracleLdp.from_scan(r0, amin, ainc, RANGE_MIN, RANGE_MAX),
            mod.OracleLdp.from_scan(r1, amin, ainc, RANGE_MIN, RANGE_MAX),
            np.zeros(3))
        out += [res.valid, res.x, res.error, res.nvalid, res.iterations]
        rng = np.random.default_rng(3)
        corrs = []
        for _ in range(60):
            p = rng.normal(size=2) * 2.0
            q = p * 0.95 + rng.normal(size=2) * 0.05
            nrm = rng.normal(size=2)
            nrm /= np.hypot(*nrm)
            corrs.append((p, q, np.outer(nrm, nrm)))
        ok, x = mod.gpc_solve(corrs)
        return out + [ok, x, mod.gpc_total_error(corrs, x)]
    if name == "spa2d":
        noisy, edges = _spa_circle()
        spa = mod.OracleSpa2d()
        for i, p in enumerate(noisy):
            spa.add_node(p, i)
        for i, j, mean, prec in edges:
            spa.add_constraint(i, j, mean, prec)
        iters = spa.do_spa(40)
        poses = spa.get_poses()
        return [iters, spa.lam, np.stack([poses[i] for i in range(24)])]
    if name == "undistort":
        out = []
        for (wx, wy), z in (((0.0, 0.0), 1.0), ((0.3, -0.2), 1.0),
                            ((0.3, -0.2), 0.0)):
            out += list(_undistort_oracle(
                mod, z, _undistort_fixture(wx=wx, wy=wy)))
        return out
    raise ValueError(name)


@pytest.mark.parametrize("name", MODULES)
def test_oracle_copy_equals_jax_package_bit_for_bit(name):
    """Each module of the port's copy gives the JAX package's outputs,
    float64 bit for bit, on the same inputs."""
    want = _run_module(name, joracle, JKartoConfig)
    got = _run_module(name, toracle, TKartoConfig)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same(a, b), (name, k, a, b)


@pytest.mark.parametrize("name", MODULES)
def test_oracle_copy_differs_only_in_its_imports(name):
    def body(path):
        lines = Path(path).read_text().splitlines()
        return [re.sub(r"\btpuslam_torch\b", "tpuslam", ln) for ln in lines]

    got = body(ROOT / "tpuslam_torch" / "oracle" / f"{name}.py")
    want = body(ROOT / "tpuslam" / "oracle" / f"{name}.py")
    assert got == want


def test_oracle_imports_neither_torch_nor_the_jax_package():
    code = (
        "import sys\n"
        "import tpuslam_torch.oracle\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'tpuslam'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert toracle.__all__ == joracle.__all__ and len(toracle.__all__) == 11


# --------------------------------------------- (ii) the port vs the oracles


def _long_loop():
    """A 134-node circuit of 0.7 m steps closed by one loop edge, from
    noisy odometry: the size of a courtyard closure's graph, where a
    block-Jacobi PCG of 60 iterations stops short of the optimum."""
    rng = np.random.default_rng(9)
    n = 134
    true = np.zeros((n, 3))
    for i in range(1, n):
        true[i] = _np_compose(true[i - 1], [0.7, 0.0, 2 * math.pi / n])
    odom = true.copy()
    for i in range(1, n):
        odom[i] = _np_compose(odom[i - 1], _rel(true[i - 1], true[i])
                              + rng.normal(0, [0.02, 0.02, 0.004]))
    prec = np.array([[400.0, 10.0, 0.0], [10.0, 300.0, 0.0],
                     [0.0, 0.0, 2000.0]])
    edges = [(i, i + 1, _rel(odom[i], odom[i + 1]), prec)
             for i in range(n - 1)]
    edges.append((0, n - 1, _rel(true[0], true[n - 1]), 2 * prec))
    return odom, edges


def _oracle_solve(poses, edges):
    spa = toracle.OracleSpa2d()
    for i, p in enumerate(poses):
        spa.add_node(p, i)
    for i, j, mean, prec in edges:
        spa.add_constraint(i, j, mean, prec)
    spa.do_spa(40)
    return np.stack([spa.get_poses()[i] for i in range(len(poses))])


def _pose_err(got, want):
    dth = np.abs(np.remainder(got[:, 2] - want[:, 2] + np.pi, 2 * np.pi)
                 - np.pi)
    return np.abs(got[:, :2] - want[:, :2]).max(), dth.max()


@pytest.mark.parametrize("graph", ["circle24", "long_loop"])
def test_spa_solver_matches_oracle(graph):
    """test_spa2d_oracle_matches_tpu_solver's bound, 5e-4 in xy and
    heading, on its 24-node circle and on a 134-node loop; on the latter
    the JAX package's step solve (PCG, 60 iterations) misses it."""
    poses, edges = _spa_circle() if graph == "circle24" else _long_loop()
    want = _oracle_solve(poses, edges)
    g = graph_from_edges(poses, edges, device="cpu")
    got, stats = make_solver("spa_solver").compute(g)
    assert float(stats.final_cost) < float(stats.initial_cost)
    dxy, dth = _pose_err(got.numpy()[:len(poses)].astype(np.float64), want)
    assert dxy < 5e-4 and dth < 5e-4, (dxy, dth)
    if graph == "long_loop":  # the JAX package's PCG steps stop short
        pcg, _ = jbackends.make_solver("spa_solver").compute(
            jbackends.graph_from_edges(poses, edges))
        pcg = np.asarray(pcg)[:len(poses)].astype(np.float64)
        assert max(_pose_err(pcg, want)) > 5e-4


@pytest.mark.parametrize("case", ["sequential", "loop_closure"])
def test_karto_pipeline_matches_oracle_mapper(case):
    """test_pipeline_parity_sequential / _loop_closure on the port: the
    same scans accepted, corrected poses within the matcher's quantization
    (sequential: half a fine cell, 1.5 fine angle steps; loop: the median
    within 5 mm, the 75th percentile within a cell, 2.5 cells at most),
    and the loop closed by both.

    The loop circle passes within 10 cm of a box (34, 30 and 25 beams
    below the 0.1 m range_min in scans 3-5 and 43-45).  The reference and
    the oracle stamp and read those readings among the unfiltered points,
    and so does the port's matcher (ROADMAP C.8); the JAX package's
    ``make_scan`` drops them.  So the loop case also holds

    (a) the JAX value to differ: over the whole circle, the port's poses
    stay within 1e-6 m of the raw-reading oracle's, while up to the
    closure (scan 29) the JAX package's part from them by half a fine cell
    or more;

    (b) every sequential match of the port to the f64 oracle's matcher run
    on the port's own state (its running scans at its poses, the
    odometry-carried prediction), within 1e-6 m and rad."""
    res_m = CFG.correlation_search_space_resolution
    if case == "sequential":
        rng = np.random.default_rng(17)
        cfg, thr = CFG, THR
        true, odom = np.zeros(3), np.zeros(3)
        stream = []
        for _ in range(8):
            stream.append((*simulate_scan(ROOM, true, num_beams=NB,
                                          max_range=30.0), odom))
            true = _np_compose(true, [0.25, 0.0, 0.12])
            odom = _np_compose(odom, np.array([0.25, 0.0, 0.12])
                               + rng.normal(0, [0.015, 0.015, 0.008]))
    else:
        cfg, jcfg, stream = _loop_circle()
        thr = 10.0
        mj = JKartoMapper(jcfg, max_scans=64)
        wit = toracle.OracleMapper(cfg)  # its matcher, on the port's state
        d_port, d_jax, d_wit = [], [], []
        closure = None
        seq = []
        orig = karto_model._fused_seq_step

        def spy(*a, **kw):
            out = orig(*a, **kw)
            seq.append(out[1])
            return out

    def oscan(k, pose=None):
        r, amin, ainc, od = stream[k]
        s = toracle.OracleScan(r, amin, ainc, range_threshold=thr,
                               minimum_range=0.1, odom_pose=od)
        if pose is not None:
            s.set_corrected_pose(pose)
        return s

    m = KartoMapper(cfg, max_scans=64, device="cpu")
    om = toracle.OracleMapper(cfg)
    closed_t = closed_o = False
    max_dp = max_dth = 0.0
    for i, (r, amin, ainc, odom) in enumerate(stream):
        kw = dict(angle_min=amin, angle_increment=ainc, range_min=0.1,
                  range_max=30.0, num_beams=NB)
        if case == "loop_closure":
            last = m.last_by_sensor.get("laser0")
            running = list(m.running_by_sensor.get("laser0", []))
            before = m.poses.copy()
            del seq[:]
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(karto_model, "_fused_seq_step", spy)
                res = m.process(tmake_scan(r, **kw), odom, time=0.0)
        else:
            res = m.process(tmake_scan(r, **kw), odom, time=0.0)
        o = oscan(i)
        assert res.processed == om.process(o), i
        closed_t |= res.loop_closed
        closed_o |= om.loop_closures > 0
        if res.processed:
            max_dp = max(max_dp, np.hypot(*(res.pose[:2]
                                            - o.corrected_pose[:2])))
            max_dth = max(max_dth, abs(math.remainder(
                res.pose[2] - o.corrected_pose[2], 2 * math.pi)))
        if case == "sequential":
            continue
        mj.process(jmake_scan(r, **kw), odom, time=0.0)
        if res.loop_closed and closure is None:
            closure = i
        d_port.append(np.hypot(*(res.pose[:2] - o.corrected_pose[:2])))
        d_jax.append(np.hypot(*(mj.poses[len(mj.records) - 1, :2]
                                - o.corrected_pose[:2])))
        if seq and seq[0] is not None:  # (b) the oracle's match, same state
            center = _np_compose(_np_compose(
                before[last], _np_inverse(m.records[last].odom_pose)), odom)
            _, want, _ = wit.seq_matcher.match_scan(
                oscan(i, center), [oscan(j, before[j]) for j in running])
            got = seq[0].pose.numpy().astype(np.float64)
            d_wit.append(max(np.hypot(*(got[:2] - want[:2])),
                             abs(math.remainder(got[2] - want[2],
                                                2 * math.pi))))
    if case == "sequential":
        assert max_dp < 0.5 * res_m, max_dp
        assert max_dth < 1.5 * CFG.fine_search_angle_offset, max_dth
        return
    assert closed_o and closed_t == closed_o
    n = len(m.records)
    assert n == len(om.scans)
    op = np.stack([s.corrected_pose for s in om.scans])
    dp = np.hypot(*(m.poses[:n, :2] - op[:, :2]).T)
    assert np.median(dp) < 5e-3, np.median(dp)
    assert float(np.quantile(dp, 0.75)) < res_m
    assert dp.max() < 2.5 * res_m, dp.max()
    # (b) the port's every sequential match is the oracle's, same state
    assert len(d_wit) == n - 1 and max(d_wit) < 1e-6, max(d_wit)
    # (a) the JAX package, blind to the readings below range_min, parts
    # from the oracle where the port holds it
    assert closure is not None and max(d_port) < 1e-6, max(d_port)
    assert max(d_jax[:closure + 1]) >= 0.5 * res_m, d_jax


def _loop_circle(n_scans=46):
    """test_karto_pipeline_matches_oracle_mapper's loop circle: the
    configuration, and per scan (ranges, angle_min, angle_increment,
    odometry) on a circle past a box (``default_rng(23)``)."""
    rng = np.random.default_rng(23)
    cfg = dataclasses.replace(CFG, use_scan_range=10.0,
                              use_response_expansion=True)
    jcfg = dataclasses.replace(JKartoConfig(**CFG_KW), use_scan_range=10.0,
                               use_response_expansion=True)
    true = np.array([1.6, 0.0, math.pi / 2])
    odom = true.copy()
    stream = []
    for _ in range(n_scans):
        r, amin, ainc = simulate_scan(world_with_boxes(), true, num_beams=NB,
                                      max_range=30.0)
        stream.append((r, amin, ainc, odom.copy()))
        dth = 2 * math.pi / 40
        step = np.array([1.6 * dth, 0.0, dth])
        true = _np_compose(true, step)
        odom = _np_compose(odom, step + rng.normal(0, [0.01, 0.01, 0.005]))
    return cfg, jcfg, stream


MATCH_PARTS = ("build_correlation_grid", "_finish_correlate",
               "_positional_covariance", "_angular_covariance")


def _record_match_parts(monkeypatch):
    """Record each match's correlation grid, its passes' surfaces (after
    normalization and penalties), best responses and read-out poses, and
    both covariances, in both packages: the JAX parts through
    ``jax.debug.callback`` from inside the mapper's jitted programs
    (retraced for it), the port's as they return."""
    import jax

    from tpuslam.match import correlative as jc
    from tpuslam_torch.match import correlative as tc

    jrec, trec = [], []

    def jwrap(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            leaves = out[:3] if isinstance(out, tuple) else (out,)
            jax.debug.callback(
                lambda *v: jrec.append((name, [np.asarray(x) for x in v])),
                *leaves, ordered=True)
            return out
        return wrapped

    def twrap(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            leaves = out[:3] if isinstance(out, tuple) else (out,)
            trec.append((name, [x.numpy() for x in leaves]))
            return out
        return wrapped

    for name in MATCH_PARTS:
        monkeypatch.setattr(jc, name, jwrap(name, getattr(jc, name)))
        monkeypatch.setattr(tc, name, twrap(name, getattr(tc, name)))
    jax.clear_caches()
    return jrec, trec


def test_loop_circle_scan_six_step_for_step(monkeypatch):
    """ROADMAP C.10, under "Known differences": on the loop circle, fed
    the readings both packages take alike (those below range_min as NaN,
    see C.8), the port from the JAX mapper's state after scan 5 matches
    scan 6 as the JAX package does, bit for bit: the correlation grid,
    the coarse and fine surfaces (the x100 sums, normalized, penalized),
    the best responses, the tie-averaged read-outs, both covariances and
    the pose.  The free runs still part there by one fine cell (2 cm),
    from a sub-1e-4 m drift: the first quantity that differs is scan 4's
    read-out, 5.4e-6 m, where no candidate responds (best 0 in every
    pass of the response expansion) and the tie average is the mean of
    all 9 x 9 x 21 coarse candidates, an f32 sum in another order than
    XLA's."""
    import jax

    from tpuslam_torch.convert import STATE_KEYS, karto_state_from_numpy

    cfg, jcfg, stream = _loop_circle(7)
    stream = [(np.where(r < 0.1, np.nan, r), amin, ainc, od)
              for r, amin, ainc, od in stream]

    def scans(k):
        r, amin, ainc, od = stream[k]
        kw = dict(angle_min=amin, angle_increment=ainc, range_min=0.1,
                  range_max=30.0, num_beams=NB)
        return jmake_scan(r, **kw), tmake_scan(r, **kw), od

    def dump(m):
        d = {k: getattr(m, k) for k in STATE_KEYS}
        d["_pts"], d["_valid"] = np.asarray(m._pts), np.asarray(m._valid)
        return karto_state_from_numpy(d)

    def parted(m, mj):
        n = len(mj.records)
        return float(np.hypot(*(m.poses[:n, :2] - mj.poses[:n, :2]).T).max())

    # the free runs: equal to 1e-4 m before scan 6, a fine cell apart there
    mt = KartoMapper(cfg, max_scans=64, device="cpu")
    mj = JKartoMapper(jcfg, max_scans=64)
    drift = []
    for k in range(7):
        js, ts, od = scans(k)
        mt.process(ts, od, time=0.0)
        mj.process(js, od, time=0.0)
        drift.append(parted(mt, mj))
    assert max(drift[:6]) < 1e-4 and drift[4] > 0, drift
    assert drift[6] > 0.5 * CFG.correlation_search_space_resolution, drift

    jrec, trec = _record_match_parts(monkeypatch)
    try:
        mj = JKartoMapper(jcfg, max_scans=64)
        steps = {}
        for k in range(7):
            js, ts, od = scans(k)
            m = KartoMapper.from_state(cfg, dump(mj), device="cpu")
            del jrec[:], trec[:]
            m.process(ts, od, time=0.0)
            mj.process(js, od, time=0.0)
            jax.effects_barrier()
            steps[k] = (list(jrec), list(trec), parted(m, mj))
    finally:
        monkeypatch.undo()
        jax.clear_caches()

    def parts(k):
        got, want, d = steps[k]
        assert [n for n, _ in got] == [n for n, _ in want], k
        assert [n for n, _ in got].count("_finish_correlate") >= 3, k
        return d, [(n, a, b) for (n, a), (_, b) in zip(want, got)]

    d, six = parts(6)
    for name, a, b in six:
        for x, y in zip(a, b):
            assert np.array_equal(x, y), (name, x, y)
    assert d == 0.0
    d, four = parts(4)
    for name, a, b in four:
        if name == "_finish_correlate":
            resp, best, mean = a
            assert np.array_equal(resp, b[0]) and best == b[1] == 0.0
            assert 0.0 < np.abs(mean - b[2]).max() < 1e-4
        elif name == "build_correlation_grid":
            assert np.array_equal(a[0], b[0])
    assert 0.0 < d < 1e-4


def test_gmapping_counters_equal_oracle():
    """test_gmapping_oracle_parity on the port (the CPU takes glibc's
    cos/sin): hits and visits equal the oracle's bit for bit."""
    nb = 240
    cfg = GmappingConfig(xmin=-10.0, xmax=10.0, ymin=-10.0, ymax=10.0,
                         delta=0.05, maxRange=12.0, maxUrange=6.0,
                         num_beams=nb, ray_steps=512)
    rng = np.random.default_rng(7)
    angles = np.linspace(-np.pi, np.pi, nb, endpoint=False) + 0.0113
    ranges = rng.uniform(0.5, 11.5, nb)
    ranges[3:7] = [0.0, np.nan, 12.7, 6.0]
    sc = tmake_scan(ranges, angle_min=float(angles[0]),
                    angle_increment=float(angles[1] - angles[0]),
                    range_min=0.0, range_max=np.inf, num_beams=nb)
    counts = gmapping.step(cfg, gmapping.init_counts(cfg, "cpu"),
                           torch.zeros(3), sc)
    spec = gmapping.make_spec(cfg)
    om = toracle.OracleGmappingMap(spec.size_x, spec.size_y, cfg.delta,
                                   0.0, 0.0)
    om.compute_map(ranges, np.cos(angles), np.sin(angles),
                   max_range=cfg.maxRange, max_use_range=cfg.maxUrange)
    np.testing.assert_array_equal(counts.hits.numpy().astype(np.int64), om.n)
    np.testing.assert_array_equal(counts.visits.numpy().astype(np.int64),
                                  om.visits)
    assert om.n.sum() > 100 and om.visits.sum() > 5000


@pytest.mark.parametrize("case", ["yaw_only", "three_axis_quirk",
                                  "three_axis"])
def test_undistort_matches_oracle(case):
    """TestUndistortOracleParity's three cases on the port: points within
    5e-5 m (and the validity masks equal under pure yaw)."""
    wx, wy = (0.0, 0.0) if case == "yaw_only" else (0.3, -0.2)
    kw = {"yaw_only": {}, "three_axis_quirk": dict(three_axis=True,
                                                   pcl_z_quirk=True),
          "three_axis": dict(three_axis=True)}[case]
    fx = _undistort_fixture(wx=wx, wy=wy)
    want, wvalid = _undistort_oracle(toracle, 0.0 if case == "three_axis"
                                     else 1.0, fx)
    n = len(fx["ranges"])
    sc = tmake_scan(fx["ranges"], angle_min=fx["amin"],
                    angle_increment=fx["inc"], range_min=0.1,
                    range_max=30.0, time_increment=fx["tinc"])
    imu = make_imu_buffer(fx["imu_t"], fx["imu_w"][:, 2], capacity=64,
                          wx=fx["imu_w"][:, 0], wy=fx["imu_w"][:, 1],
                          device="cpu")
    got, gvalid = undistort(UndistortConfig(num_beams=n, **kw), sc, imu,
                            torch.tensor(fx["odom_rel"], dtype=torch.float32),
                            fx["t0"], fx["t1"])
    got, m = got.numpy().astype(np.float64), gvalid.numpy()
    if case == "yaw_only":
        assert np.array_equal(m, wvalid)
    d = got.shape[1]
    np.testing.assert_allclose(got[m], want[m][:, :d], atol=5e-5, rtol=0)


@pytest.mark.parametrize("method", ["auto", "kernel"])
@pytest.mark.parametrize("case,bound", [("clean", 2e-3), ("quirk", 3e-3)])
def test_icp_matches_oracle(method, case, bound):
    """TestPclIcpOracleParity on the port, the dense chain and the
    kernel's nearest mode (its plain version here): the node's clouds
    (invalid beams at the origin), all points valid, both converged."""
    p0, rel = (((0.4, -0.2, 0.2), (0.05, -0.03, 0.02)) if case == "clean"
               else ((-0.5, 0.3, -0.8), (0.03, 0.02, -0.015)))
    p1 = _np_compose(np.asarray(p0, float), np.asarray(rel, float))
    r0, r1, amin, ainc = _pair_scans(p0, p1, seed=0 if case == "clean" else 3)
    if case == "quirk":
        r0[10:25] = np.nan
        r1[100:115] = np.inf
    src, tgt = (toracle.icp_pcl.convert_scan_to_cloud(r, amin, ainc,
                                                      RANGE_MIN, RANGE_MAX)
                for r in (r0, r1))
    ores = toracle.OraclePclIcp().align(src, tgt)
    allv = torch.ones(PAIR_NB, dtype=torch.bool)
    tres = icp(IcpConfig(num_beams=PAIR_NB, correspondence_method=method),
               torch.tensor(src, dtype=torch.float32), allv,
               torch.tensor(tgt, dtype=torch.float32), allv)
    assert ores.converged and bool(tres.converged)
    np.testing.assert_allclose(tres.pose.numpy(), ores.x, atol=bound,
                               rtol=0)


def test_chip_smoke_oracle_phase_on_the_cpu():
    """chip_smoke.py's phase 4o, every sub-phase and bound, rehearsed on
    the CPU at 181 beams (the outdoor configuration with a 18 m range,
    three matches) on the 134-node loop's graph."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cfg = dataclasses.replace(outdoor_karto_config(), num_beams=181,
                              use_scan_range=18.0)
    out = chip_smoke.run_oracle_phase(cfg, "cpu", "cpu", _long_loop(),
                                      num_beams=181, k=3)
    assert out["karto"]["matches"] == 3 and out["spa"]["nodes"] == 134
    assert out["hector"]["map_update"]["differing_cells"] == 0
    assert out["gmapping"]["differing_cells"] == 0


# ------------------------------------------------- (iii) the native codec


def _log():
    log, _ = bag.synthesize(num_beams=181, num_scans=24, seed=2)
    log.ranges[0, 3] = np.nan
    log.ranges[1, 4] = np.inf
    log.stamps = log.stamps + 1.7e9  # epoch stamps keep their f64 bits
    return log


def _logs_equal(a, b):
    for f in ("ranges", "stamps", "odom", "imu_wz"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), f
    for f in ("angle_min", "angle_increment", "range_min", "range_max",
              "time_increment"):
        assert getattr(a, f) == getattr(b, f), f


def test_native_codec_writes_the_plain_and_jax_bytes(tmp_path):
    log = _log()
    paths = {c: tmp_path / f"{c}.tslg" for c in ("native", "python", "jax")}
    bag.save_tslg(paths["native"], log, codec="native")
    bag.save_tslg(paths["python"], log)  # the default codec
    jbag.save_tslg(paths["jax"], jbag.ScanLog(
        log.ranges, log.stamps, log.odom, log.imu_wz, log.angle_min,
        log.angle_increment, log.range_min, log.range_max,
        log.time_increment))
    want = paths["jax"].read_bytes()
    assert paths["native"].read_bytes() == want
    assert paths["python"].read_bytes() == want
    from tpuslam_torch.io import _native

    lib = Path(_native.BUILD_INFO["path"])
    assert lib.parent == ROOT / "build" / "tpuslam_torch"
    assert lib.name.startswith("libtslg_") and lib.is_file()


def test_native_and_plain_loads_are_equal(tmp_path):
    log = _log()
    p = tmp_path / "log.tslg"
    bag.save_tslg(p, log, codec="native")
    native, plain = bag.load_tslg(p, codec="native"), bag.load_tslg(p)
    _logs_equal(native, plain)
    for f in ("ranges", "stamps", "odom", "imu_wz"):  # the header is f32
        np.testing.assert_array_equal(getattr(native, f), getattr(log, f))
    assert native.angle_min == float(np.float32(log.angle_min))
    _logs_equal(bag.load(str(p)), plain)
    with pytest.raises(ValueError, match="codec"):
        bag.load_tslg(p, codec="rust")


@pytest.mark.parametrize("codec", ["native", "python"])
@pytest.mark.parametrize("fault", ["magic", "truncated", "short_header"])
def test_bad_tslg_files_raise(tmp_path, codec, fault):
    p = tmp_path / "log.tslg"
    bag.save_tslg(p, _log(), codec="python")
    raw = p.read_bytes()
    p.write_bytes({"magic": b"TSLX" + raw[4:], "truncated": raw[:-7],
                   "short_header": raw[:20]}[fault])
    with pytest.raises(IOError):
        bag.load_tslg(p, codec=codec)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from tpuslam_torch.io import _native

    bad = tmp_path / "scanlog.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the .tslg codec"):
        _native.load()
    assert not list((tmp_path / "build").glob("*.so"))
