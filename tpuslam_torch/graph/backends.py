"""Pose-graph solver backends: the reference's ScanSolver seam
(counterpart of ``tpuslam/graph/backends.py``).

The reference ships four backends behind ``karto::ScanSolver``
(Mapper.h:825-891), selected by ``solver_type`` (karto_slam.cc:254-284).
They minimise the same residual and differ in iteration strategy, so one
engine (``graph/solver.py``) serves them all:

- ``spa_solver``:   LM, 40 iterations (spa_solver.cc:43-61),
- ``ceres_solver``: LM with a tiny initial lambda, 100 iterations
  (ceres_solver.cc:131-196),
- ``g2o_solver``:   true Gauss-Newton, 40 iterations (g2o_solver.cc:112),
- ``gtsam_solver``: LM, up to 500 iterations (gtsam_solver.cc:30-99; the
  adapter's covariance-as-noise quirk is fixed, node 0 is anchored).

Custom backends register with :func:`register_solver`.
"""

from __future__ import annotations

from typing import Callable, Protocol

import numpy as np
import torch

from tpuslam_torch.graph.solver import PoseGraph, SolveStats, optimize


class ScanSolver(Protocol):
    """The reference's ScanSolver surface (Mapper.h:825-891), on tensors."""

    def compute(self, graph: PoseGraph) -> tuple[torch.Tensor, SolveStats]:
        """Optimize and return (corrected poses, stats)."""
        ...


class LmSolver:
    """Configurable LM/GN solver over the shared engine."""

    def __init__(
        self,
        num_iters: int = 40,
        cg_iters: int = 60,
        init_lambda: float = 1e-4,
        n_fixed: int = 1,
        gauss_newton: bool = False,
    ):
        self.num_iters = num_iters
        self.cg_iters = cg_iters
        self.init_lambda = init_lambda
        self.n_fixed = n_fixed
        self.gauss_newton = gauss_newton

    def compute(self, graph: PoseGraph) -> tuple[torch.Tensor, SolveStats]:
        return optimize(
            graph,
            num_iters=self.num_iters,
            cg_iters=self.cg_iters,
            init_lambda=self.init_lambda,
            n_fixed=self.n_fixed,
            gauss_newton=self.gauss_newton,
        )


_REGISTRY: dict[str, Callable[[], ScanSolver]] = {
    "spa_solver": lambda: LmSolver(num_iters=40),
    "ceres_solver": lambda: LmSolver(num_iters=100, init_lambda=1e-8),
    "g2o_solver": lambda: LmSolver(
        num_iters=40, init_lambda=0.0, gauss_newton=True
    ),
    "gtsam_solver": lambda: LmSolver(num_iters=500, init_lambda=1e-5),
}


def register_solver(name: str, factory: Callable[[], ScanSolver]) -> None:
    _REGISTRY[name] = factory


def make_solver(name: str) -> ScanSolver:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown solver_type {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]()


def graph_from_edges(
    poses: np.ndarray,
    edges: list[tuple[int, int, np.ndarray, np.ndarray]],
    device=None,
) -> PoseGraph:
    """A float32 PoseGraph on ``device`` from host-side pose/edge lists.

    No capacity padding: the JAX version pads to power-of-two buckets only
    to reuse compiled programs."""
    n, e = len(poses), len(edges)
    p = np.asarray(poses[:n], np.float32).reshape(n, 3)
    edge_i = np.asarray([x[0] for x in edges], np.int64)
    edge_j = np.asarray([x[1] for x in edges], np.int64)
    meas = np.asarray([x[2] for x in edges], np.float32).reshape(e, 3)
    prec = np.asarray([x[3] for x in edges], np.float32).reshape(e, 3, 3)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return PoseGraph(
        poses=dev(p),
        node_mask=torch.ones(n, dtype=torch.bool, device=device),
        edge_i=dev(edge_i),
        edge_j=dev(edge_j),
        measurements=dev(meas),
        precisions=dev(prec),
        edge_mask=torch.ones(e, dtype=torch.bool, device=device),
    )
