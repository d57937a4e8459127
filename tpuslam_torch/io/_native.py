"""Build and load the native ``.tslg`` codec, ``tpuslam_torch/csrc/scanlog.cc``.

On first use the source is compiled by the host C++ compiler (``$CXX``,
else ``c++`` on the PATH)::

    c++ -O2 -shared -fPIC -o build/tpuslam_torch/libtslg_<hash>.so \
        tpuslam_torch/csrc/scanlog.cc

and loaded with ``ctypes``.  ``<hash>`` is a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one reused.  Several
processes may load the codec at once (parallel test workers, say): the
build runs under an exclusive file lock beside the library, into a
temporary file that ``os.replace`` renames into place, so no process opens
a library that is half written.  A failed build or load raises; there is no
fallback (``io/bag.py``'s ``codec="python"`` is the plain version, chosen
by the caller).

The C ABI (``scanlog.cc``; every call returns 0 on success, negative on an
error)::

    tslg_write(path, num_beams, num_records, angle_min, angle_increment,
               range_min, range_max, time_increment, stamps, odom,
               imu_wz, ranges) -> int
    tslg_open(path, meta[5] f64, counts[2] i64) -> handle (NULL on error)
    tslg_read(handle, start, count, stamps, odom, imu_wz, ranges) -> int
    tslg_close(handle) -> int
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "scanlog.cc"
BUILD_DIR = _PKG.parent / "build" / "tpuslam_torch"
FLAGS = ("-O2", "-shared", "-fPIC")

_P = ctypes.c_void_p
_U32 = ctypes.c_uint32
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry points: name -> (argtypes, restype)
SIGNATURES = {
    "tslg_write": ((ctypes.c_char_p, _U32, _U32, _F, _F, _F, _F, _F,
                    _P, _P, _P, _P), ctypes.c_int),
    "tslg_open": ((ctypes.c_char_p, _P, _P), ctypes.c_void_p),
    "tslg_read": ((_P, _I64, _I64, _P, _P, _P, _P), ctypes.c_int),
    "tslg_close": ((_P,), ctypes.c_int),
}

# what the last load reported: seconds, library path, whether it compiled
BUILD_INFO: dict = {}
_lock = threading.Lock()
_lib = None


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, then ``c++`` on the PATH."""
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX unset and no c++ on the "
                           "PATH): the native .tslg codec cannot be built")
    return cxx


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    """Compile into ``target`` under a file lock shared by every process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.is_file():  # another process built it meanwhile
            return
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [find_cxx(), *FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the .tslg codec failed "
                                   f"({proc.returncode}):\n{' '.join(cmd)}"
                                   f"\n{proc.stdout}")
            os.replace(tmp, target)  # atomic: a loader sees all or none
        finally:
            tmp.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The codec library, compiled on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libtslg_{_digest()}.so"
        t0 = time.perf_counter()
        compiled = not target.is_file()
        if compiled:
            _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        BUILD_INFO.update(path=str(target), compiled=compiled,
                          seconds=time.perf_counter() - t0)
        _lib = lib
        return lib
