"""Headless visualization: the rviz replacement (SURVEY §5 observability),
a copy of ``tpuslam/utils/viz.py`` (NumPy and matplotlib only).

The reference validates visually in rviz (occupancy maps, trajectories,
pose-graph MarkerArrays, karto_slam.cc:603-682).  tpuslam renders the same
artifacts to PNG with matplotlib — usable from the CLI (``--png out.png``)
and in notebooks.  Soft dependency: raises a clear error if matplotlib is
missing.
"""

from __future__ import annotations

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for tpuslam_torch.utils.viz renderings"
        ) from e


def render_map(
    path: str,
    grid_img: np.ndarray,
    *,
    resolution: float = 1.0,
    origin=(0.0, 0.0),
    trajectory: np.ndarray | None = None,
    graph_edges: np.ndarray | None = None,
    title: str | None = None,
) -> None:
    """Render an int8 occupancy map (-1 unknown / 0 free / 100 occupied) with
    optional trajectory [T, 3] and pose-graph edge segments [E, 2, 2]."""
    plt = _plt()
    img = np.asarray(grid_img)
    # default (unknown-grey) fill so values outside {-1, 0, 100} — e.g.
    # intermediate ROS probabilities 1..99 or uint8-stored -1 — render
    # deterministically instead of as uninitialized memory
    rgb = np.full(img.shape + (3,), 0.66, np.float32)
    rgb[img == 0] = (1.0, 1.0, 1.0)
    rgb[img == 100] = (0.05, 0.05, 0.05)
    mid = (img > 0) & (img < 100)
    rgb[mid] = 1.0 - (img[mid, None].astype(np.float32) / 100.0) * 0.95

    h, w = img.shape
    x0, y0 = origin
    extent = (x0, x0 + w * resolution, y0, y0 + h * resolution)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(rgb, origin="lower", extent=extent, interpolation="nearest")
    if graph_edges is not None and len(graph_edges):
        for (ax_, ay_), (bx_, by_) in graph_edges:
            ax.plot([ax_, bx_], [ay_, by_], color="#4477aa", lw=0.6, alpha=0.7)
    if trajectory is not None and len(trajectory):
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 1], color="#cc3311", lw=1.2)
        ax.plot(t[0, 0], t[0, 1], "o", color="#cc3311", ms=4)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)


def karto_graph_segments(mapper) -> np.ndarray:
    """[E, 2, 2] world segments of the pose graph (rviz MarkerArray analog,
    karto_slam.cc:603-682)."""
    if not mapper.edges:
        return np.zeros((0, 2, 2))
    return np.stack(
        [
            np.stack([mapper.poses[i][:2], mapper.poses[j][:2]])
            for i, j, _, _ in mapper.edges
        ]
    )
