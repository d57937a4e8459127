"""LIO-SAM-style curvature corner extraction (lesson1), counterpart of
``tpuslam/ops/features.py``.

Behavioral contract (reference: lesson1/src/feature_detection.cc):

- finite beams are compacted front-to-back preserving order (93-106),
- curvature ``c_i = (sum_{j in i±1..5} r_j - 10 r_i)^2`` over the compacted
  ranges (112-124), defined for i in [5, count-5),
- the compacted scan splits into 6 equal segments (139-150); each segment
  contributes up to 20 corners, chosen as the highest-curvature points with
  ``c > edge_threshold = 1.0`` (152-170, threshold set at 69),
- output is the sparse corner subset in original beam indexing (127-174).

Every scan of a batch and every segment is done at once: the compaction
is a stable sort by validity, the 11-beam window sum a difference of a
cumulative sum, and the picks one stable sort of the six segments' scores.
Three rules make the result the JAX package's bit for bit on any device:

- the cumulative sum adds in jitted ``jnp.cumsum``'s order
  (``core.xla_cpu.cumsum``), so every curvature, and with it every
  threshold decision, is the same;
- ``lax.top_k`` lets the lower index win a tie; a stable ascending sort of
  the negated scores does the same;
- the picks are marked by a scatter of ``True`` (duplicates write the
  same value), a dropped pick going to an extra cell that is cut off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core.config import FeatureConfig
from tpuslam_torch.core.scan import Scan
from tpuslam_torch.core.xla_cpu import cumsum


class FeatureResult(NamedTuple):
    corner_mask: torch.Tensor  # [..., B] bool — corners, ORIGINAL beam indexing
    curvature: torch.Tensor  # [..., B] f32 — curvature, original indexing (0 invalid)


def extract_features(cfg: FeatureConfig, scan: Scan) -> FeatureResult:
    """Corners and curvature of a scan or a batch of scans [..., B]."""
    shape = scan.ranges.shape
    n = shape[-1]
    r = scan.ranges.reshape(-1, n)
    valid = scan.valid.reshape(-1, n)
    hw = cfg.curvature_halfwin

    # stable compaction permutation: valid beams first, original order kept
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    cr = torch.gather(r, -1, order)
    cv = torch.gather(valid, -1, order)
    nv = valid.sum(-1, keepdim=True)

    # window sum over 2*hw+1 beams via a padded cumsum;
    # sum_{j != i} r_j - 2*hw*r_i  =  S - (2*hw+1)*r_i
    crp = torch.nn.functional.pad(cr, (hw, hw))
    csum = torch.cat([torch.zeros_like(crp[:, :1]), cumsum(crp)], -1)
    s = csum[:, 2 * hw + 1:] - csum[:, :n]
    d = s - (2 * hw + 1) * cr
    c = d * d

    pos = torch.arange(n, device=r.device)
    in_window = (pos >= hw) & (pos < nv - hw)
    c = torch.where(in_window, c, 0.0)

    # the reference's exact segment bounds (feature_detection.cc:141-146):
    # start_j = nv*j//6, end_j = nv*(j+1)//6 - 1 (inclusive); a degenerate
    # segment (start >= end) contributes nothing.  The unsorted end element
    # is picked FIRST when above threshold (150-170): it scores +inf.
    eligible = in_window & (c > cfg.edge_threshold)
    seg = torch.arange(cfg.num_segments, device=r.device)[:, None]
    start = (nv[:, None] * seg) // cfg.num_segments  # [T, S, 1]
    end = (nv[:, None] * (seg + 1)) // cfg.num_segments - 1
    member = (pos >= start) & (pos <= end) & (start < end)
    scored = torch.where(
        eligible[:, None] & member,
        torch.where(pos == end, torch.inf, c[:, None]),
        -torch.inf,
    )
    k = min(cfg.max_corners_per_segment, n)
    neg, idx = torch.sort(-scored, dim=-1, stable=True)
    picked = neg[..., :k] < torch.inf  # the top-k score > -inf
    drop = torch.full_like(idx[..., :k], n)
    sel = torch.where(picked, idx[..., :k], drop).reshape(r.shape[0], -1)
    corner_c = torch.zeros((r.shape[0], n + 1), dtype=torch.bool,
                           device=r.device).scatter_(-1, sel, True)[:, :n]

    # scatter back to original beam indexing
    corner_mask = torch.zeros_like(valid).scatter_(-1, order, corner_c & cv)
    curvature = torch.zeros_like(c).scatter_(-1, order, c)
    return FeatureResult(corner_mask=corner_mask.reshape(shape),
                         curvature=curvature.reshape(shape))


def corner_scan(scan: Scan, feats: FeatureResult) -> Scan:
    """Sparse corner republish: the reference emits a LaserScan whose
    non-corner beams are zeroed (feature_detection.cc:127-174)."""
    keep = feats.corner_mask & scan.valid
    return scan._replace(
        ranges=torch.where(keep, scan.ranges, 0.0), valid=keep
    )
