"""The port's public surface pinned to the JAX package's.

Every module ``tpuslam/<path>.py`` is parsed with ``ast`` (never
imported): each public top-level ``def`` / ``class`` and each name in its
``__all__`` must exist in ``tpuslam_torch/<path>.py``.  The exceptions
are ``LEAVE_BEHIND``: patterns (``fnmatch``) of module names or public
names that the port does not carry, each with its reason.  A new name in
the JAX package without a counterpart fails here, and so does an entry
of ``LEAVE_BEHIND`` that matches nothing in the JAX package any more.
"""

import ast
import fnmatch
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "tpuslam"

LEAVE_BEHIND = {
    "pallas_*": "the Pallas kernels: each is ported as a CUDA kernel in "
                "tpuslam_torch/csrc/ with its wrapper in tpuslam_torch/ops/",
    "mxu_interp": "the MXU one-hot sampler: ported as ops/bilinear.py's "
                  "windowed sampler",
    "gn_system_mxu": "its counterpart is match/hector.py's windowed "
                     "sampler (matcher_impl 'mxu')",
    "pyramid_hw_flops": "a TPU MXU cost model with no meaning on the card",
    "vmem_*": "TPU VMEM budgets of the Pallas kernels",
    "corr_vmem_fits": "a TPU VMEM budget of the Pallas correspondences",
    "stride2_vmem_fits": "a TPU VMEM budget of the stride-2 patch sums",
    "_native": "a build directory of the JAX package, not a module",
}


def _public(path: Path) -> set[str]:
    """Public top-level defs and classes, and the names in ``__all__``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names.update(ast.literal_eval(node.value))
    return names


def _left(name: str) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in LEAVE_BEHIND)


def _module_parts(path: Path) -> tuple[str, ...]:
    parts = path.relative_to(REFERENCE).with_suffix("").parts
    return parts[:-1] if parts[-1] == "__init__" else parts


MODULES = sorted(REFERENCE.rglob("*.py"))


@pytest.mark.parametrize(
    "path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_carries_the_public_names(path):
    parts = _module_parts(path)
    if any(_left(p) for p in parts):
        return  # a module the port leaves behind as a whole
    port = importlib.import_module(".".join(("tpuslam_torch",) + parts))
    missing = sorted(n for n in _public(path)
                     if not _left(n) and not hasattr(port, n))
    assert not missing, (f"{port.__name__} lacks {missing} of "
                         f"{path.relative_to(ROOT)}")


@pytest.mark.parametrize("pattern", list(LEAVE_BEHIND))
def test_leave_behind_entries_still_exist(pattern):
    found = {p for path in MODULES for p in _module_parts(path)}
    for path in MODULES:
        found |= _public(path)
    assert fnmatch.filter(sorted(found), pattern), (
        f"LEAVE_BEHIND entry {pattern!r} matches nothing in tpuslam/")


def test_core_reexports_like_the_reference():
    from tpuslam_torch import core
    from tpuslam_torch.core import Scan, make_scan, se2
    from tpuslam_torch.core.scan import Scan as ScanClass
    from tpuslam_torch.core.scan import make_scan as make_scan_fn

    assert Scan is ScanClass and make_scan is make_scan_fn
    assert se2.__name__ == "tpuslam_torch.core.se2"
    assert set(core.__all__) == _public(REFERENCE / "core" / "__init__.py")
    for name in core.__all__:
        assert hasattr(core, name), name
    with pytest.raises(AttributeError):
        core.not_a_name  # noqa: B018


def test_core_config_imports_no_torch():
    """The re-exports load on first access: reading a config pulls in no
    torch, numpy or other module of the package."""
    code = (
        "import sys, tpuslam_torch.core.config\n"
        "mods = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'tpuslam_torch'))\n"
        "assert mods == ['tpuslam_torch', 'tpuslam_torch.core', "
        "'tpuslam_torch.core.config'], mods\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=60)
