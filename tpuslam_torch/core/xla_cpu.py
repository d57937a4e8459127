"""f32 arithmetic written the way jitted XLA computes it on the CPU.

The JAX package's functions run under ``jax.jit``; on the CPU, XLA
contracts ``a*b + c`` into FMAs, takes glibc's ``cosf``/``sinf`` for
``jnp.cos``/``jnp.sin`` (elementwise, vectorised or not), and rewrites a
cumulative sum into a blocked scan.  Where the port must equal the JAX
package bit for bit (the Karto map, the GMapping counters, the feature
curvature, the correlative matcher's points), it spells out the same
arithmetic with these helpers.  Each is exact f32 arithmetic that gives
the same bits on every device, except :func:`cos_sin` and :func:`rotate`,
which take XLA's CPU arithmetic only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

# XLA's ReduceWindowRewriter base length on the CPU: a cumulative sum of n
# elements becomes scans of 16-element blocks plus a scan of the blocks'
# totals, recursively
_SCAN_BLOCK = 16


@functools.lru_cache(maxsize=1)
def libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return lib


def cos_sin_f32(theta: np.ndarray) -> np.ndarray:
    """[n, 2] f32 (cos, sin) of f32 angles from the C library's cosf and
    sinf: the values the jitted JAX package takes on the CPU (XLA calls
    them there)."""
    lib = libm()
    return np.array([(lib.cosf(float(t)), lib.sinf(float(t)))
                     for t in np.asarray(theta, np.float32).reshape(-1)],
                    np.float32).reshape(-1, 2)


def cos_sin(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of an f32 tensor: glibc's cosf/sinf for a CPU tensor
    (so that a CPU run equals jitted JAX bit for bit), the device's own
    ``torch.cos``/``torch.sin`` (within an ulp or two of them) on CUDA,
    where the host does not read the angles."""
    if theta.device.type != "cpu":
        return torch.cos(theta), torch.sin(theta)
    cs = torch.from_numpy(cos_sin_f32(theta.numpy())).reshape(
        *theta.shape, 2)
    return cs[..., 0], cs[..., 1]


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a*b + c`` rounded once, as an FMA: the product is exact in
    f64, so only a double rounding at an exact f32 tie could differ."""
    return (a.double() * b.double() + c.double()).float()


def rotate(c: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
           y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(c*x - s*y, s*x + c*y)``: with jitted XLA's FMAs for CPU tensors
    (``fma(c, x, -(s*y))``, ``fma(s, x, c*y)``), the JAX package's bits
    there; the plain products on another device, whose cos and sin are
    its own (:func:`cos_sin`), so that no parity is to be had and the
    FMA's route through f64 would only add operations."""
    if c.device.type != "cpu":
        return c * x - s * y, s * x + c * y
    return fma(c, x, -(s * y)), fma(s, x, c * y)


def clipped_endpoints(pts: torch.Tensor, pose: torch.Tensor, thr: float):
    """Ranges ``|pts|`` and world endpoints of sensor-frame points [k, B, 2]
    at poses [k, 1, 4] (x, y, cos, sin), over-threshold points clipped to
    the threshold ray point (Karto.h:5866-5888).  Rounded as jitted XLA
    rounds ``jnp.linalg.norm`` and ``se2.transform_points`` on the CPU:
    ``sqrt(fma(y, y, x*x))``, ``fma(c, x, -(s*y)) + px`` and
    ``fma(s, x, c*y) + py``."""
    x, y = pts[..., 0], pts[..., 1]
    # the f32 square root correctly rounded, through f64 (PyTorch's
    # vectorised f32 sqrt on the CPU is not)
    r = torch.sqrt(fma(y, y, x * x).double()).float()
    # thr / r as one division (a Python scalar over a tensor would take
    # the reciprocal and multiply)
    scale = torch.where(
        r > thr, torch.full_like(r, thr) / r.clamp_min(1e-9), 1.0)
    return r, transform_fma(pose, x * scale, y * scale)


def transform_fma(pose: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """World points [..., 2] of sensor-frame ``x``, ``y`` at ``pose``
    [..., 4] = (px, py, cos, sin) broadcast against them, with jitted
    XLA's FMAs of ``se2.transform_points``."""
    c, s = pose[..., 2], pose[..., 3]
    wx = fma(c, x, -(s * y)) + pose[..., 0]
    wy = fma(s, x, c * y) + pose[..., 1]
    return torch.stack([wx, wy], -1)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last dimension in the order of jitted
    ``jnp.cumsum`` on the CPU: left-to-right within blocks of 16, each
    block offset by the (recursively blocked) scan of the totals before
    it.  f32 adds in a fixed order, so the same bits on every device
    (``torch.cumsum`` accumulates in f64 on the CPU and in a third order
    on CUDA)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for k in range(1, n):
            cols.append(cols[-1] + x[..., k])
        return torch.stack(cols, -1)
    m = -(-n // _SCAN_BLOCK) * _SCAN_BLOCK
    blocks = torch.nn.functional.pad(x, (0, m - n)).reshape(
        *x.shape[:-1], m // _SCAN_BLOCK, _SCAN_BLOCK)
    inner = cumsum(blocks)
    totals = cumsum(inner[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                       -1)
    return (inner + before[..., None]).reshape(*x.shape[:-1], m)[..., :n]
