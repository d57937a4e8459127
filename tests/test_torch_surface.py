"""The port's public surface pinned to the JAX package's.

Every module ``tpuslam/<path>.py`` is parsed with ``ast`` (never
imported): each public top-level ``def`` / ``class`` and each name in its
``__all__`` must exist in ``tpuslam_torch/<path>.py``.  The exceptions
are ``LEAVE_BEHIND``: patterns (``fnmatch``) of module names or public
names that the port does not carry, each with its reason.  A new name in
the JAX package without a counterpart fails here, and so does an entry
of ``LEAVE_BEHIND`` that matches nothing in the JAX package any more.

The call forms too, parsed alike from both trees: for each public
function, public method, ``__init__``, NamedTuple and dataclass of the
JAX package with a counterpart, every JAX positional parameter (or field)
sits at the same position in the port, every keyword-only one exists
there, the port requires nothing the JAX package does not (so its own
parameters, such as ``device``, come after the JAX package's or are
keyword-only), and literal defaults are equal (``jnp.<dtype>`` read as
``torch.<dtype>``).  ``SIGNATURE_DIFFERENCES`` holds each allowed
difference with its reason; an entry that no longer differs fails.
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


# ---------------------------------------------------------------------------
# signatures

# (module path under tpuslam/, qualified name) -> why the port's signature
# may differ from the JAX package's.  A port counterpart that takes
# ``*args, **kwargs`` is not compared, and must be listed here.
SIGNATURE_DIFFERENCES: dict[tuple[str, str], str] = {
    ("graph/solver.py", "empty_graph"):
        "dtype defaults to torch.float64, not float32: the port's solve is "
        "float64 throughout (graph_from_edges, the LM state), and an f32 "
        "graph would solve in f32",
}


def _port_file(parts: tuple[str, ...]) -> Path:
    base = ROOT / "tpuslam_torch" / Path(*parts) if parts else (
        ROOT / "tpuslam_torch")
    return base / "__init__.py" if base.is_dir() else base.with_suffix(
        ".py")


def _defs(path: Path) -> dict[str, ast.AST]:
    """Top-level ``def`` and ``class`` nodes of a module by name, and the
    names it imports from the port (``from tpuslam_torch.x import y``)
    resolved to their defining module's node."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif (isinstance(node, ast.ImportFrom) and node.module
              and node.module.split(".")[0] == "tpuslam_torch"):
            src = _port_file(tuple(node.module.split(".")[1:]))
            for alias in node.names:
                if src.is_file() and alias.name in (
                        found := _defs(src)):
                    out[alias.asname or alias.name] = found[alias.name]
    return out


def _record_fields(node: ast.ClassDef) -> list[ast.arg] | None:
    """A NamedTuple's or dataclass's fields as constructor parameters
    (``arg`` nodes, each with its default or None), else None."""
    bases = {ast.unparse(b) for b in node.bases}
    decos = {ast.unparse(d).split("(")[0] for d in node.decorator_list}
    if not ({"NamedTuple", "typing.NamedTuple"} & bases
            or {"dataclass", "dataclasses.dataclass"} & decos):
        return None
    fields = []
    for item in node.body:
        if isinstance(item, ast.AnnAssign) and isinstance(item.target,
                                                          ast.Name):
            arg = ast.arg(arg=item.target.id)
            arg.default = item.value
            fields.append(arg)
    return fields


def _params(fn: ast.FunctionDef):
    """(positional args with defaults, keyword-only args with defaults,
    has *args, has **kwargs) of a def."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for arg, d in zip(pos, defaults):
        arg.default = d
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        arg.default = d
    return pos, a.kwonlyargs, a.vararg is not None, a.kwarg is not None


def _callables(node: ast.AST):
    """(qualified name, signature) of a public def, or of a public
    class's fields and its public methods and ``__init__``; a signature
    is ``_params``'s tuple."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        yield node.name, _params(node)
        return
    fields = _record_fields(node)
    yield node.name, None if fields is None else (fields, [], False, False)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                not item.name.startswith("_") or item.name == "__init__"):
            yield f"{node.name}.{item.name}", _params(item)


def _default(node) -> str | None:
    """A default as comparable text, ``jnp.<dtype>`` written as
    ``torch.<dtype>``; None for no default."""
    if node is None:
        return None
    text = ast.unparse(node)
    for prefix in ("jnp.", "jax.numpy."):
        if text.startswith(prefix):
            text = "torch." + text[len(prefix):]
    try:
        return repr(ast.literal_eval(text))
    except (ValueError, SyntaxError):
        return text


def _literal(node) -> bool:
    if node is None:
        return False
    text = ast.unparse(node)
    try:
        ast.literal_eval(text)
        return True
    except (ValueError, SyntaxError):
        return text.startswith(("jnp.", "jax.numpy.", "torch.", "np."))


def _signature_faults(jax_sig, port_sig) -> list[str]:
    """How a call form of ``jax_sig`` would fail or bind otherwise
    against ``port_sig``, one line a fault."""
    if port_sig is None or jax_sig is None:
        return ["a record (NamedTuple or dataclass) in one package alone"]
    jpos, jkw, jvar, jvkw = jax_sig
    ppos, pkw, pvar, pvkw = port_sig
    if pvar and pvkw and not (jvar and jvkw):
        return ["the port takes *args, **kwargs: not compared"]
    faults = []
    pnames = [a.arg for a in ppos]
    for i, a in enumerate(jpos):
        if i >= len(ppos) or ppos[i].arg != a.arg:
            faults.append(f"positional {a.arg!r} is not at position {i} "
                          f"(port: {pnames})")
    port_by_name = {a.arg: a for a in ppos + pkw}
    jax_by_name = {a.arg: a for a in jpos + jkw}
    for a in jkw:
        if a.arg not in port_by_name and not pvkw:
            faults.append(f"keyword-only {a.arg!r} is missing")
    if jvar and not pvar:
        faults.append("*args is missing")
    if jvkw and not pvkw:
        faults.append("**kwargs is missing")
    for a in ppos + pkw:
        if a.default is None and (a.arg not in jax_by_name
                                  or jax_by_name[a.arg].default is not None):
            faults.append(f"{a.arg!r} is required in the port alone")
    for name, a in jax_by_name.items():
        p = port_by_name.get(name)
        if (p is not None and _literal(a.default) and _literal(p.default)
                and _default(a.default) != _default(p.default)):
            faults.append(f"{name!r} defaults to {_default(p.default)}, "
                          f"not {_default(a.default)}")
    return faults


def _signatures(path: Path):
    """(qualified name, JAX signature, port signature) of every public
    callable of a JAX module that has a counterpart in the port."""
    parts = _module_parts(path)
    if any(_left(p) for p in parts):
        return
    port = _defs(_port_file(parts))
    for node in ast.parse(path.read_text()).body:
        name = getattr(node, "name", "")
        if (not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
                or name.startswith("_") or _left(name)):
            continue
        twin = port.get(name)
        if twin is None:
            continue  # test_port_carries_the_public_names' fault
        theirs = dict(_callables(twin))
        for qual, sig in _callables(node):
            if qual in theirs and (sig, theirs[qual]) != (None, None):
                yield qual, sig, theirs[qual]


@pytest.mark.parametrize(
    "path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_takes_the_reference_call_forms(path):
    rel = str(path.relative_to(REFERENCE))
    faults = []
    for qual, jsig, psig in _signatures(path):
        if (rel, qual) in SIGNATURE_DIFFERENCES:
            continue
        faults += [f"{qual}: {f}" for f in _signature_faults(jsig, psig)]
    assert not faults, f"{rel}:\n" + "\n".join(faults)


@pytest.mark.parametrize("key", list(SIGNATURE_DIFFERENCES),
                         ids=lambda k: "::".join(k))
def test_signature_differences_still_differ(key):
    rel, qual = key
    sigs = {q: (j, p) for q, j, p in _signatures(REFERENCE / rel)}
    assert qual in sigs, f"{rel}::{qual} is no callable with a counterpart"
    assert _signature_faults(*sigs[qual]), (
        f"{rel}::{qual} takes the JAX package's call forms now: drop its "
        f"SIGNATURE_DIFFERENCES entry")
