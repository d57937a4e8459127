"""``chip_smoke.py``'s path phases rehearsed on the CPU at small sizes.

The card's gate runs these functions at production widths; here each runs
on the CPU with the kernels' plain versions, with fewer beams, scans and
map cells: the PL-ICP odometry (4d), frame to frame (4e),
``process_batch`` in each mode (4h), the Hector engine (4g) and the
endurance stream (4j).  Each must return
without raising, with its checks' outputs and no timing: the gate checks
and leaves the card's time to the benchmark (``portbench``).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def _timed_keys(out, path="") -> list:
    """Every key of ``out`` (nested dicts and lists too) that names a
    time or a rate: seconds, milliseconds, microseconds, a rate a second,
    a busy share or a profile."""
    found = []
    if isinstance(out, dict):
        for k, v in out.items():
            if (k in ("seconds", "ms", "busy_share", "profile")
                    or k.endswith(("_s", "_ms", "_us", "_seconds", "per_s",
                                   "_seconds_total"))):
                found.append(f"{path}{k}")
            found += _timed_keys(v, f"{path}{k}.")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            found += _timed_keys(v, f"{path}{i}.")
    return found


def _karto_cfg():
    from tpuslam_torch.core.config import outdoor_karto_config

    return dataclasses.replace(outdoor_karto_config(), num_beams=90,
                               use_scan_range=18.0)


def test_odometry_phase_on_the_cpu(smoke):
    from tpuslam_torch.core.config import PlicpConfig

    out, poses = smoke.run_odometry("cpu", 180, 40, repeat=20)
    assert poses.shape == (40, 3) and np.isfinite(poses).all()
    assert out["scans"] == 40 and out["repeat"]["equal"]
    assert out["passes"] == smoke.plicp_passes(
        PlicpConfig(num_beams=180, kf_scan_count=6), 39)
    assert not any(out["launches"].values())  # the plain versions
    assert np.isfinite(out["ate_rmse_m"])
    assert _timed_keys(out) == []


def test_frame_to_frame_phase_on_the_cpu(smoke):
    out = smoke.run_frame_to_frame("cpu", 180, 20)
    assert set(out) == {"plicp", "icp", "icp_auto"}
    for r in out.values():
        assert r["scans"] == 20 and r["poses"].shape == (19, 3)
        assert not any(r["launches"].values())
    assert np.array_equal(out["icp"]["poses"], out["icp_auto"]["poses"])
    assert out["plicp"]["passes"] > 0
    assert _timed_keys(out) == []


@pytest.mark.parametrize("mode", ["sequential", "parallel", "pipeline4"])
def test_batch_phase_on_the_cpu(smoke, mode):
    assert mode in smoke.BATCH_MODES
    out, m = smoke.run_batch(_karto_cfg(), "cpu", 90, mode=mode)
    assert out["mode"] == mode and out["processed"] == len(m.records)
    assert len(out["processed_flags"]) == out["scans"]
    assert out["loop_closures"] >= 1
    assert out["checked_dispatches"] == 0  # the sync check is the card's
    assert _timed_keys(out) == []


def test_hector_engine_phase_on_the_cpu(smoke):
    from tpuslam_torch.core.config import HectorConfig

    cfg = HectorConfig(map_size=512, num_beams=361, ray_steps=512,
                       map_update_distance_thresh=0.1,
                       map_update_angle_thresh=0.15)
    out = smoke.run_hector_engine("cpu", 361, 60, cfg=cfg, repeat=20)
    assert out["scans"] == 60 and out["map_updates"] > 0
    assert out["ate_rmse_m"] < 0.05
    assert out["repeat"] == {"scans": 20, "runs": 2, "equal": True}
    assert _timed_keys(out) == []


def test_endurance_phase_on_the_cpu(smoke):
    out = smoke.run_endurance("cpu", 200)
    assert out["accepted"] == out["scans"] == 200
    assert out["count_ok"] and out["episodes_ok"]
    assert out["closures"] >= 1 and out["solves"] >= 1
    assert _timed_keys(out) == []
