"""IMU + wheel-odometry motion-distortion correction (lesson5),
counterpart of ``tpuslam/models/undistort.py``.

Behavioral contract (reference: lesson5/src/lidar_undistortion.cc):

- gyro rates are integrated into a cumulative rotation over the scan span
  (``imu_rot_*[k] = imu_rot_*[k-1] + omega * dt``, 177-249),
- odometry start/end poses give the scan-period translation
  ``transBt = transBegin^-1 · transEnd`` (252-336),
- each beam i at time ``t_i = t0 + i*time_increment`` gets its rotation by
  linear interpolation between bracketing IMU samples (398-432) and its
  translation by the linear time ratio (435-447),
- the corrected point is re-expressed in the FIRST beam's frame via
  ``p' = (T_start^-1 · T_i) p`` (339-394).

Two rotation modes (``cfg.three_axis``): the reference-exact 3-axis mode
(per-beam ``Rz(yaw)·Ry(pitch)·Rx(roll)`` as ``pcl::getTransformation``
builds it, 3D points) and the yaw-only mode for level platforms (2D
points).

The deque pruning becomes fixed-size sample arrays with validity masks.
The interpolation brackets each query with a [B, K] comparison and
masked sums (``interp_bracketed``): exact f32, the same on every device,
with np.interp's clamps at both ends.  The gyro integral adds in jitted
``jnp.cumsum``'s order (``core.xla_cpu.cumsum``).  The cos and sin are
PyTorch's, not glibc's, so points part from the JAX package's by ~1e-7 m.

Every time is in seconds relative to the scan, in f32 on the device: a
caller rebases absolute stamps (a ROS bag's are seconds since 1970,
where an f32 ulp is 128 s) on the host in f64 first, as the command line
does (``cli._undistort_args``).  :func:`make_imu_buffer` and
:func:`undistort` raise ``ValueError`` on times that f32 cannot resolve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.core.config import UndistortConfig
from tpuslam_torch.core.scan import Scan, scan_to_points
from tpuslam_torch.core.xla_cpu import cumsum


class ImuBuffer(NamedTuple):
    """Fixed-capacity gyro sample buffer (the reference's imu deque)."""

    stamps: torch.Tensor  # [K] sample times (s), ascending; invalid = +inf
    wz: torch.Tensor  # [K] yaw rate (rad/s)
    valid: torch.Tensor  # [K]
    wx: torch.Tensor  # [K] roll rate (rad/s); zeros when only yaw is sampled
    wy: torch.Tensor  # [K] pitch rate (rad/s)


def _check_f32_times(times, span: float, what: str) -> None:
    """Raise ``ValueError`` if rounding ``times`` (host seconds) to f32
    moves one by more than a thousandth of ``span``: such stamps are
    absolute (epoch) times, and the sweep is lost in their f32 cast."""
    t = np.asarray(times, np.float64).reshape(-1)
    t = t[np.isfinite(t)]
    err = np.abs(t.astype(np.float32).astype(np.float64) - t)
    if span > 0 and err.size and err.max() > 1e-3 * span:
        raise ValueError(
            f"{what}: f32 cannot resolve times near {t[err.argmax()]:.6g} "
            f"s over a {span:.3g} s span; pass times relative to the scan "
            f"(rebase absolute stamps on the host in f64)")


def make_imu_buffer(stamps, wz, capacity: int, wx=None, wy=None,
                    device="cuda") -> ImuBuffer:
    """The gyro samples at ``stamps`` (seconds relative to the scan, on
    the time base of ``undistort``'s ``t0``/``t1``) in a buffer of
    ``capacity``."""
    stamps64 = np.asarray(stamps, np.float64)
    if stamps64.size > 1:
        _check_f32_times(stamps64, float(np.ptp(stamps64)), "make_imu_buffer")
    stamps = stamps64.astype(np.float32)
    k = min(len(stamps), capacity)
    out_t = np.full(capacity, np.inf, np.float32)
    out_v = np.zeros(capacity, bool)
    out_t[:k] = stamps[:k]
    out_v[:k] = True

    def fill(w):
        out = np.zeros(capacity, np.float32)
        if w is not None:
            out[:k] = np.asarray(w, np.float32)[:k]
        return torch.as_tensor(out, device=device)

    return ImuBuffer(torch.as_tensor(out_t, device=device), fill(wz),
                     torch.as_tensor(out_v, device=device), fill(wx),
                     fill(wy))


def interp_bracketed(t: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """np.interp for ascending ``xs``, boundary clamps included, without
    searchsorted: each query is bracketed by a [B, K] comparison and the
    bracket's ends selected by masked sums (one nonzero term each, so
    exact).  ``t`` of any shape; the result has its shape."""
    k = xs.shape[0]
    t1d = t.reshape(-1)
    ge = t1d[:, None] >= xs[None, :]
    idx = torch.clamp(ge.sum(1) - 1, 0, k - 2)
    cols = torch.arange(k, device=xs.device)[None, :]
    oh0 = idx[:, None] == cols
    oh1 = idx[:, None] + 1 == cols
    x0 = torch.where(oh0, xs[None, :], 0.0).sum(1)
    x1 = torch.where(oh1, xs[None, :], 0.0).sum(1)
    y0 = torch.where(oh0, ys[None, :], 0.0).sum(1)
    y1 = torch.where(oh1, ys[None, :], 0.0).sum(1)
    w = torch.clamp((t1d - x0) / torch.clamp_min(x1 - x0, 1e-12), 0.0, 1.0)
    return (y0 + w * (y1 - y0)).reshape(t.shape)


def integrate_gyro(imu: ImuBuffer, t0: torch.Tensor,
                   rates: torch.Tensor) -> torch.Tensor:
    """Cumulative rotation from scan start: rot[k] = sum w*dt from t0
    (lidar_undistortion.cc:213-249).  Samples before t0 contribute 0."""
    dt = torch.diff(imu.stamps, prepend=imu.stamps[:1])
    dt = torch.where(imu.valid & (imu.stamps > t0), dt, 0.0)
    dt = torch.clamp(dt, 0.0, 1.0)  # guard inf gaps at the invalid tail
    return cumsum(rates * dt)


def undistorted_scan(
    cfg: UndistortConfig,
    scan: Scan,
    imu: ImuBuffer,
    odom_rel: torch.Tensor,
    t0: float,
    t1: float,
) -> Scan:
    """Undistort, then re-express the corrected cloud AS a Scan: range =
    |p|, angle = atan2(y, x), so scan_to_points gives back the corrected
    cloud (modulo one f32 polar round-trip) and the engines consume it as
    they consume any scan (lidar_undistortion.launch chains the node in
    front of the matchers).  Only the ``valid`` beams are corrected, so
    the readings below range_min (``Scan.near``) are dropped, as the
    corrected cloud drops them.  Planar configs only."""
    if cfg.three_axis:
        raise ValueError(
            "undistorted_scan: three_axis clouds are 3D; consume "
            "undistort() points directly"
        )
    pts, valid = undistort(cfg, scan, imu, odom_rel, t0, t1)
    r = torch.hypot(pts[..., 0], pts[..., 1])
    ang = torch.atan2(pts[..., 1], pts[..., 0])
    return Scan(
        ranges=torch.where(valid, r, 0.0),
        angles=torch.where(valid, ang, scan.angles),
        valid=valid,
        stamps=scan.stamps,
        near=torch.zeros_like(valid),
    )


def undistort(
    cfg: UndistortConfig,
    scan: Scan,
    imu: ImuBuffer,
    odom_rel: torch.Tensor,  # [3] transBt: base motion over [t0, t1] (odom frame)
    t0: float,
    t1: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Correct one scan; returns (points [B, 2] in the beam-0 frame, or
    [B, 3] in three_axis mode, and valid [B]).

    ``t0``, ``t1`` and the IMU buffer's stamps are seconds relative to the
    scan (``t0`` its first beam's time, usually 0), all on one time base;
    a beam's time is ``t0 + scan.stamps``.  Absolute stamps must be
    rebased on the host in f64 before they come here: the same scan gives
    the same points whatever its stamps' origin.  Raises ``ValueError``
    if f32 cannot resolve ``t0`` or ``t1``."""
    _check_f32_times([t0, t1], float(t1) - float(t0), "undistort")
    dev = scan.ranges.device
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    odom_rel = torch.as_tensor(odom_rel, dtype=torch.float32, device=dev)
    pts, valid = scan_to_points(scan)
    t_i = t0 + scan.stamps

    if cfg.use_imu:
        safe_stamps = torch.where(imu.valid, imu.stamps, 1e30)

        def rel_rot(rates):
            cum = integrate_gyro(imu, t0, rates)
            return (interp_bracketed(t_i, safe_stamps, cum)
                    - interp_bracketed(t0, safe_stamps, cum))

        yaw_i = rel_rot(imu.wz)
        if cfg.three_axis:
            roll_i = rel_rot(imu.wx)
            pitch_i = rel_rot(imu.wy)
    else:
        ratio_r = (t_i - t0) / torch.clamp_min(t1 - t0, 1e-9)
        yaw_i = ratio_r * odom_rel[2]
        if cfg.three_axis:
            roll_i = torch.zeros_like(yaw_i)
            pitch_i = torch.zeros_like(yaw_i)

    if cfg.use_odom:
        ratio = torch.clamp((t_i - t0) / torch.clamp_min(t1 - t0, 1e-9),
                            0.0, 1.0)
        txy_i = ratio[:, None] * odom_rel[:2]
    else:
        txy_i = torch.zeros_like(pts)

    x, y = pts[:, 0], pts[:, 1]
    if cfg.three_axis:
        # per-beam R = Rz(yaw)·Ry(pitch)·Rx(roll) as pcl::getTransformation
        # composes it (lidar_undistortion.cc:357-394); beam 0 is the
        # identity by construction (integrals start at t0)
        cr, sr = torch.cos(roll_i), torch.sin(roll_i)
        cp, sp = torch.cos(pitch_i), torch.sin(pitch_i)
        cy, sy = torch.cos(yaw_i), torch.sin(yaw_i)
        # the reference transforms the beam as (x, y, 1.0) — see
        # UndistortConfig.pcl_z_quirk; z adds Rz·Ry·Rx's third column
        z = 1.0 if cfg.pcl_z_quirk else 0.0
        out = torch.stack(
            [
                cy * cp * x + (cy * sp * sr - sy * cr) * y
                + (cy * sp * cr + sy * sr) * z + txy_i[:, 0],
                sy * cp * x + (sy * sp * sr + cy * cr) * y
                + (sy * sp * cr - cy * sr) * z + txy_i[:, 1],
                -sp * x + cp * sr * y + cp * cr * z,
            ],
            dim=-1,
        )
        return out, valid

    # T_i = (txy_i, yaw_i); beam 0 has T_0 = identity, so p' = T_i p
    c, s = torch.cos(yaw_i), torch.sin(yaw_i)
    out = torch.stack(
        [c * x - s * y + txy_i[:, 0], s * x + c * y + txy_i[:, 1]], dim=-1
    )
    return out, valid
