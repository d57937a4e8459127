"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program under test either; names are
compared as whole top-level module names (``tpuslam_torch`` is the port,
``tpuslam`` the JAX package)."""

import ast
import json
import subprocess
import sys
import types

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "tpuslam"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=run.ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_entries_and_readers_load_no_jax():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    loaded = _loaded(
        "from portbench import run, calibrate, bag, check, roofline, trace\n"
        f"for w in {cells!r}:\n"
        "    run.find_cell(w, False); run.find_cell(w, True)\n")
    assert "tpuslam_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_references_load_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.plicp, portbench.reference.icp")
    assert not loaded & (FORBIDDEN | {"tpuslam_torch"})


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted((run.ROOT / "portbench").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & FORBIDDEN, (path, tops)
            if "reference" in path.parts:
                assert "tpuslam_torch" not in tops, path


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuslam_torchlike", types.ModuleType("x"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "tpuslam.core", types.ModuleType("y"))
    assert run.loaded_forbidden() == ["tpuslam"]
