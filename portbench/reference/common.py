"""What the two matchers' references share: SE(2) algebra, the dense
nearest-point search and the weighted rigid fit."""

from __future__ import annotations

import torch

# the contracts' sentinel squared distance where either point is invalid
BIG = 1e9


def wrap(theta: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def transform(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pose [P, 3] applied to points [P, B, 2]."""
    c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([c * x - s * y + pose[:, 0:1],
                        s * x + c * y + pose[:, 1:2]], dim=-1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a after b, [P, 3]."""
    c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    return torch.stack([a[:, 0] + c * b[:, 0] - s * b[:, 1],
                        a[:, 1] + s * b[:, 0] + c * b[:, 1],
                        wrap(a[:, 2] + b[:, 2])], dim=-1)


def take(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts [P, B', 2] at idx [P, B] -> [P, B, 2]."""
    return torch.gather(pts, 1, idx[..., None].expand(*idx.shape, 2))


def nearest(cur, src_valid, ref, ref_valid, line: bool):
    """The exhaustive search: d1 = the least squared distance from each
    source point to a reference point (BIG where either is invalid), j1 =
    the first index that reaches it; with ``line``, also the closer scan
    neighbour j2 of j1 and whether one exists (an edge or an invalid
    neighbour reads BIG).  Returns (j1, d1, j2, has_neighbour)."""
    d2 = (cur[:, :, None, 0] - ref[:, None, :, 0]).square_()
    d2.addcmul_(*(2 * [cur[:, :, None, 1] - ref[:, None, :, 1]]))
    d2.masked_fill_(~ref_valid[:, None, :], BIG)
    j1 = d2.argmin(-1)
    d1 = torch.gather(d2, -1, j1[..., None])[..., 0]
    d1 = torch.where(src_valid, d1, BIG)
    if not line:
        return j1, d1, None, None
    last = d2.shape[-1] - 1
    d_r = torch.gather(d2, -1, (j1 + 1).clamp(max=last)[..., None])[..., 0]
    d_l = torch.gather(d2, -1, (j1 - 1).clamp(min=0)[..., None])[..., 0]
    d_r = torch.where(j1 == last, BIG, d_r)
    d_l = torch.where(j1 == 0, BIG, d_l)
    j2 = torch.where(d_r < d_l, j1 + 1, j1 - 1).clamp(0, last)
    return j1, d1, j2, torch.minimum(d_r, d_l) < BIG


def rigid_fit(src, dst, w):
    """The weighted least-squares rigid motion taking src onto dst, [P, 3]."""
    wn = w / torch.clamp(w.sum(-1), min=1e-9)[:, None]
    mu_s = (wn[..., None] * src).sum(1)
    mu_d = (wn[..., None] * dst).sum(1)
    ps, pd = src - mu_s[:, None], dst - mu_d[:, None]
    cross = (wn * (ps[..., 0] * pd[..., 1] - ps[..., 1] * pd[..., 0])).sum(-1)
    dot = (wn * (ps[..., 0] * pd[..., 0] + ps[..., 1] * pd[..., 1])).sum(-1)
    th = torch.atan2(cross, dot)
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([mu_d[:, 0] - (c * mu_s[:, 0] - s * mu_s[:, 1]),
                        mu_d[:, 1] - (s * mu_s[:, 0] + c * mu_s[:, 1]), th],
                       dim=-1)
