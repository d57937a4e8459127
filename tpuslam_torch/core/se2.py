"""SE(2) pose algebra on tensors ``[..., 3]`` = (x, y, theta).

Counterpart of ``tpuslam/core/se2.py``; every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def identity(batch_shape: tuple = (), dtype=torch.float32,
             device="cuda") -> torch.Tensor:
    """Identity poses, shape ``batch_shape + (3,)``, on ``device``."""
    return torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)


def rotation(theta: torch.Tensor) -> torch.Tensor:
    """2x2 rotation matrices, shape [..., 2, 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b : apply b then a (T_a @ T_b as homogeneous matrices)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], dim=-1)


def inverse(p: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return torch.stack([x, y, -p[..., 2]], dim=-1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹ ∘ b — the motion that takes frame a to frame b."""
    return compose(inverse(a), b)


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose [..., 3] to points [..., N, 2] (broadcasting over batch)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x = pts[..., 0]
    y = pts[..., 1]
    nx = c[..., None] * x - s[..., None] * y + pose[..., 0:1]
    ny = s[..., None] * x + c[..., None] * y + pose[..., 1:2]
    return torch.stack([nx, ny], dim=-1)


def to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """Homogeneous 3x3 matrices, shape [..., 3, 3]."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    row0 = torch.stack([c, -s, pose[..., 0]], dim=-1)
    row1 = torch.stack([s, c, pose[..., 1]], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def from_matrix(mat: torch.Tensor) -> torch.Tensor:
    theta = torch.atan2(mat[..., 1, 0], mat[..., 0, 0])
    return torch.stack([mat[..., 0, 2], mat[..., 1, 2], theta], dim=-1)


def interp(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """Pose interpolation with shortest-arc angle blending: ``b - a``'s
    angle is wrapped before the blend (lesson5
    lidar_undistortion.cc:398-447).  ``alpha`` broadcasts against the
    batch shape; a number is taken in the poses' dtype."""
    if not torch.is_tensor(alpha):
        alpha = torch.tensor(alpha, dtype=a.dtype, device=a.device)
    dxy = b[..., :2] - a[..., :2]
    dth = wrap_angle(b[..., 2] - a[..., 2])
    xy = a[..., :2] + alpha[..., None] * dxy
    th = wrap_angle(a[..., 2] + alpha * dth)
    return torch.cat([xy, th[..., None]], dim=-1)


def exp(twist: torch.Tensor) -> torch.Tensor:
    """SE(2) exponential map from a twist (vx, vy, omega)."""
    vx, vy, w = twist[..., 0], twist[..., 1], twist[..., 2]
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    sw, cw = torch.sin(w_safe), torch.cos(w_safe)
    a = torch.where(small, 1.0 - w * w / 6.0, sw / w_safe)
    b = torch.where(small, w / 2.0, (1.0 - cw) / w_safe)
    x = a * vx - b * vy
    y = b * vx + a * vy
    return torch.stack([x, y, wrap_angle(w)], dim=-1)


def log(pose: torch.Tensor) -> torch.Tensor:
    """SE(2) logarithm map to a twist."""
    x, y, th = pose[..., 0], pose[..., 1], wrap_angle(pose[..., 2])
    small = torch.abs(th) < 1e-6
    th_safe = torch.where(small, torch.ones_like(th), th)
    half = th_safe / 2.0
    cot = half / torch.tan(half)
    a = torch.where(small, 1.0 - th * th / 12.0, cot)  # (th/2)cot(th/2)
    b = torch.where(small, -th / 2.0, -half)
    vx = a * x - b * y
    vy = b * x + a * y
    return torch.stack([vx, vy, th], dim=-1)
