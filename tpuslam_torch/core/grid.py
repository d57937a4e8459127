"""Static grid geometry: world <-> map affine transforms (counterpart of
``tpuslam/core/grid.py``).

Continuous *map coordinates* are ``m = (w - origin) / resolution``; cell
(ix, iy) holds the value anchored at integer map coordinate (ix, iy), and
grids are indexed ``grid[iy, ix]`` (reference: GridMapBase.h:229-286,
OccGridMapUtil.h:139-228).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _origin_tensor(x: float, y: float, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """[x, y] on ``device``, made once: a tensor made from Python numbers on
    a CUDA device is a copy that waits for the device's stream, and the
    transforms run several times a match.  Read-only: callers take it as
    an operand."""
    return torch.tensor([x, y], dtype=dtype, device=device)


def recip(d: float) -> float:
    """The f32 reciprocal 1/d, as a Python float."""
    return float(np.float32(1.0) / np.float32(d))


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (hashable)."""

    resolution: float  # meters per cell (reference default 0.05, hector_slam.cc:138)
    size_x: int  # cells along x (columns)
    size_y: int  # cells along y (rows)
    origin_x: float  # world x of map coord (0, 0)
    origin_y: float  # world y of map coord (0, 0)

    @classmethod
    def centered(
        cls,
        resolution: float,
        size: int,
        start_frac: float = 0.5,
        start_frac_y: float | None = None,
    ) -> "GridSpec":
        """Square map with the world origin at ``start_frac`` of the map —
        hector's mapStart coords (hector_slam.cc:143-145); ``start_frac_y``
        sets the y fraction independently (defaults to ``start_frac``)."""
        extent = size * resolution
        fy = start_frac if start_frac_y is None else start_frac_y
        return cls(
            resolution, size, size, -extent * start_frac, -extent * fy
        )

    @property
    def shape(self) -> tuple[int, int]:
        return (self.size_y, self.size_x)

    def coarsen(self, factor: int = 2) -> "GridSpec":
        """The next pyramid level: resolution x factor, size / factor, same
        world extent (MapRepMultiMap.h:57-90)."""
        return GridSpec(
            self.resolution * factor,
            self.size_x // factor,
            self.size_y // factor,
            self.origin_x,
            self.origin_y,
        )

    def _origin(self, like: torch.Tensor) -> torch.Tensor:
        return _origin_tensor(self.origin_x, self.origin_y, like.dtype,
                              like.device)

    # --- point transforms -------------------------------------------------
    def world_to_map(self, pts: torch.Tensor) -> torch.Tensor:
        """World points [..., 2] -> continuous map coords [..., 2].

        The division is the multiply by the f32 reciprocal that the jitted
        JAX package (and PyTorch on CUDA) runs for a division by a
        constant, so a cell boundary falls where it falls there."""
        return (pts - self._origin(pts)) * recip(self.resolution)

    def map_to_world(self, mpts: torch.Tensor) -> torch.Tensor:
        return mpts * self.resolution + self._origin(mpts)

    # --- pose transforms (scale x,y, keep theta: GridMapBase.h:229-242) ---
    def world_pose_to_map(self, pose: torch.Tensor) -> torch.Tensor:
        xy = self.world_to_map(pose[..., :2])
        return torch.cat([xy, pose[..., 2:3]], dim=-1)

    def map_pose_to_world(self, pose: torch.Tensor) -> torch.Tensor:
        xy = self.map_to_world(pose[..., :2])
        return torch.cat([xy, pose[..., 2:3]], dim=-1)

    # --- index helpers -----------------------------------------------------
    def in_bounds(self, ix: torch.Tensor, iy: torch.Tensor,
                  margin: int = 0) -> torch.Tensor:
        return (
            (ix >= margin)
            & (ix < self.size_x - margin)
            & (iy >= margin)
            & (iy < self.size_y - margin)
        )

    def flat_index(self, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
        """Row-major flat index with clamping (callers mask separately)."""
        ixc = torch.clamp(ix, 0, self.size_x - 1)
        iyc = torch.clamp(iy, 0, self.size_y - 1)
        return iyc * self.size_x + ixc
