"""SE(2) pose algebra on tensors ``[..., 3]`` = (x, y, theta).

Counterpart of ``tpuslam/core/se2.py``; every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


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
