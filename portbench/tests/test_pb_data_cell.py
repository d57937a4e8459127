"""A cell added as data only, a configuration, a traffic mix and the
``BENCHMARK.json`` entries, is found and run with no code edited."""

import json

from portbench import run


def test_a_cell_added_as_data_runs(tiny_root):
    root = tiny_root
    base = json.loads((root / "portbench/configs/plicp_utm30lx.json").read_text())
    base.update(name="plicp_lms100", scanner={
        "model": "a 181-beam scanner", "beams": 181, "fov_deg": 270.0,
        "range_min_m": 0.1, "range_max_m": 20.0, "scan_hz": 50.0})
    (root / "portbench/configs/plicp_lms100.json").write_text(json.dumps(base))
    traffic = json.loads((root / "portbench/traffic/bag.json").read_text())
    traffic.update(name="room", scans=7, pairs_per_call=3, speed_m_s=0.5,
                   course={"straight_m": 2.0, "radius_m": 1.0},
                   world={"room_m": [8.0, 6.0], "boxes": [[-3.0, 0.0, 1.0]]})
    (root / "portbench/traffic/room.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # the readers BENCHMARK.json lists for the PL-ICP cell the new one copies
    plicp_readers = {m["name"] for m in bench["per_layer"]
                     if "plicp_utm30lx.bag" in m.get("workloads", [])}
    bench["configs"].append({"name": "plicp_lms100", "source": "made up",
                             "file": "portbench/configs/plicp_lms100.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "plicp_lms100.room",
                               "config": "plicp_lms100", "traffic": "room",
                               "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        if "plicp_utm30lx.bag" in m.get("workloads", []):
            m["workloads"].append("plicp_lms100.room")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = run.find_cell("plicp_lms100.room", False, root)
    result, info, _ = run.run_cell(cell, 5, 0.2, False, "cpu")
    work = json.loads(info[0].split(" ", 2)[2])
    assert (work["beams"], work["scans"], work["pairs_per_call"]) == (181, 7, 3)
    assert result["correct"]
    assert set(result["metrics"]) == {"scans_per_s", "setup_s"}
    traced = run.find_cell("plicp_lms100.room", True, root)
    assert set(traced.readers) == plicp_readers
    assert {"plicp_corr.line_roofline", "plicp_batch.rest_device_ms",
            "host.launches_per_call", "device.idle_pct"} <= plicp_readers
    result, _, _ = run.run_cell(traced, 6, 0.2, True, "cpu")
    assert result["correct"] and "busy_s" in result["device"]
