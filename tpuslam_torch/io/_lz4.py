"""LZ4 *frame* codec over the system liblz4, bound with ctypes: a copy of
``tpuslam/io/_lz4.py``, so that the port imports nothing of the JAX
package.

rosbag's lz4 chunk compression (ros_comm's roslz4, ``lz4s.c``) writes the
standard LZ4 Frame format — magic ``0x184D2204``, 64 KB blocks — which
liblz4's ``LZ4F_*`` API reads and writes directly.  CPython has no stdlib
lz4 codec and the optional ``lz4`` wheel is not vendored in this
environment, but the shared library is (``liblz4.so.1``), so the two
entry points are bound here with ctypes: no build step, no dependency.

``available()`` reports whether the library loaded; callers fall back to
the ``lz4`` package (if importable) and then to a clear error.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib: ctypes.CDLL | None = None
_load_failed = False


def _load() -> ctypes.CDLL:
    global _lib, _load_failed
    if _lib is None:
        if _load_failed:
            raise OSError("liblz4 unavailable")
        try:
            name = ctypes.util.find_library("lz4") or "liblz4.so.1"
            lib = ctypes.CDLL(name)
            lib.LZ4F_isError.restype = ctypes.c_uint
            lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
            lib.LZ4F_getVersion.restype = ctypes.c_uint
            lib.LZ4F_getVersion.argtypes = []
            lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
            lib.LZ4F_compressFrameBound.argtypes = [
                ctypes.c_size_t, ctypes.c_void_p,
            ]
            lib.LZ4F_compressFrame.restype = ctypes.c_size_t
            lib.LZ4F_compressFrame.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ]
            lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
            lib.LZ4F_createDecompressionContext.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint,
            ]
            lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
            lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
            lib.LZ4F_decompress.restype = ctypes.c_size_t
            lib.LZ4F_decompress.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_void_p,
            ]
            _lib = lib
        except (OSError, AttributeError):
            _load_failed = True
            raise OSError("liblz4 unavailable")
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def compress(data: bytes) -> bytes:
    """One-shot LZ4 frame compression (LZ4F_compressFrame)."""
    lib = _load()
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    out = ctypes.create_string_buffer(bound)
    n = lib.LZ4F_compressFrame(out, bound, data, len(data), None)
    if lib.LZ4F_isError(n):
        raise ValueError(f"LZ4F_compressFrame failed (code {n})")
    return out.raw[:n]


def decompress(data: bytes) -> bytes:
    """Streaming LZ4 frame decompression (LZ4F_decompress loop)."""
    lib = _load()
    ctx = ctypes.c_void_p()
    err = lib.LZ4F_createDecompressionContext(
        ctypes.byref(ctx), lib.LZ4F_getVersion()
    )
    if lib.LZ4F_isError(err):
        raise ValueError(f"LZ4F context creation failed (code {err})")
    try:
        chunks: list[bytes] = []
        pos = 0
        cap = max(4 * len(data), 1 << 20)
        dst = ctypes.create_string_buffer(cap)
        while pos < len(data):
            dst_sz = ctypes.c_size_t(cap)
            src_sz = ctypes.c_size_t(len(data) - pos)
            ret = lib.LZ4F_decompress(
                ctx, dst, ctypes.byref(dst_sz),
                data[pos:], ctypes.byref(src_sz), None,
            )
            if lib.LZ4F_isError(ret):
                raise ValueError(f"LZ4F_decompress failed (code {ret})")
            if dst_sz.value:
                chunks.append(dst.raw[: dst_sz.value])
            if src_sz.value == 0 and dst_sz.value == 0:
                raise ValueError("LZ4 frame stalled (truncated input?)")
            pos += src_sz.value
            if ret == 0 and pos < len(data):
                # frame complete with trailing bytes: rosbag chunks hold
                # exactly one frame, so trailing data is corruption
                raise ValueError("trailing bytes after LZ4 frame")
        return b"".join(chunks)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)
