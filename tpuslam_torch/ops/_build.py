"""Build and load the hand-written Hopper kernels in ``tpuslam_torch/csrc``.

On first use every ``csrc/*.cu`` is compiled by its own ``nvcc``, all
started together, and the objects are linked into one shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj dir>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC \
         -o build/tpuslam_torch/libtpuslam_torch_<hash>.so <obj dir>/*.o

and loaded with ``ctypes``.  ``<hash>`` is a hash of the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.
``--fmad=false`` keeps nvcc from contracting ``a*b + c`` into an FMA:
the FindValidPoints walk and the correspondence distances must evaluate
their f32 expressions in the reference's exact order.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p``, its sizes as ``c_int`` and its f32 scalars as ``c_float``,
and returns ``cudaGetLastError()`` after its launch; :func:`check` raises
when that is not 0.  With no ``nvcc`` the loader raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpuslam_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = (*_ARCH, "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (pointers and the stream c_void_p, ints
# c_int, f32 scalars c_float)
SIGNATURES = {
    # q, g, ay, ax, ok, n_a, b, s, stride, out, stream
    "tpuslam_patch_sums": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # px, py, pv, vp, s, b, dec, keep, out, stream
    "tpuslam_fvp": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P),
    # cur, sv, ref, rv, n, b, nr, max_d2, line, doubles,
    # q1, q2, d1, ok, j1, best, stream
    "tpuslam_plicp_corr": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P),
}
_ERROR_STRING = "tpuslam_error_string"  # int code -> const char*

# what the last build reported: seconds, library path, nvcc's -Xptxas -v
BUILD_INFO: dict = {}
_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the tpuslam_torch CUDA kernels cannot be "
        "built on this machine"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _check_nvcc(cmd: list[str], rc: int, log: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")


def _compile(nvcc: str, sources: list[Path], target: Path) -> str:
    """One nvcc per source, all at once, then one link; returns the logs."""
    work = target.parent / f"{target.stem}.{os.getpid()}.objs"
    work.mkdir(parents=True, exist_ok=True)
    objs = [str(work / f"{src.stem}.o") for src in sources]
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", o, str(src)]
                for src, o in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]  # waits for every one
        for cmd, proc, log in zip(cmds, procs, logs):
            _check_nvcc(cmd, proc.returncode, log)
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *objs]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout)
        os.replace(tmp, target)  # atomic: a loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(work, ignore_errors=True)
    return "\n".join(logs + [proc.stdout])


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        target = BUILD_DIR / f"libtpuslam_torch_{_digest(sources)}.so"
        t0 = time.perf_counter()
        log = ""
        if not target.is_file():
            log = _compile(find_nvcc(), sources, target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        err = getattr(lib, _ERROR_STRING)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        BUILD_INFO.update(
            path=str(target),
            seconds=time.perf_counter() - t0,
            compiled=bool(log),
            log=log,
        )
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        what = getattr(load(), _ERROR_STRING)(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} at launch ({what})")
