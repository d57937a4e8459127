"""Sparse 2D pose-graph optimizer: Levenberg-Marquardt + block-Jacobi PCG
(counterpart of ``tpuslam/graph/solver.py``).

The residual model of the reference's SPA2d backend
(lesson6/lib/sparse_bundle_adjustment/src/spa2d.cpp):

- ``e = [R0^T (t1 - t0) - t_mean;  wrap(th1 - th0 - th_mean)]`` with a 3x3
  precision per edge (calcErr, spa2d.cpp:148-159),
- analytic Jacobians ``J0 = [-R0^T, dR0^T/dth (t1-t0); 0, -1]``,
  ``J1 = [R0^T, 0; 0, 1]`` (setJacobians, spa2d.cpp:86-142),
- LM: solve ``(H + lambda*D) dx = -g``, accept if the cost drops
  (lambda *= 0.5) else reject (lambda *= laminc, laminc *= 2),
  spa2d.cpp:555-582; converged when ``|dx|^2 < 1e-16``; the gauge is fixed
  by the first ``n_fixed`` nodes.

``H x`` is matrix-free: two gathers, two 3x3 matvecs and two
``index_add_`` scatters per edge, solved by conjugate gradients
preconditioned with the inverse diagonal blocks.  Plain PyTorch, no
kernel: the JAX solver has no Pallas kernel either.  The JAX version runs
a fixed number of masked iterations under ``lax.scan``; here the loops
stop at convergence, which gives the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core import se2


class PoseGraph(NamedTuple):
    """Pose graph as tensors (``node_mask``/``edge_mask`` gate padding)."""

    poses: torch.Tensor  # [N, 3] node estimates (x, y, theta)
    node_mask: torch.Tensor  # [N] bool — active nodes
    edge_i: torch.Tensor  # [E] int64 — source node (constraint frame)
    edge_j: torch.Tensor  # [E] int64 — target node
    measurements: torch.Tensor  # [E, 3] pose of j in i's frame
    precisions: torch.Tensor  # [E, 3, 3] information matrices
    edge_mask: torch.Tensor  # [E] bool — active edges


def residuals(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """[E, 3] constraint errors (spa2d.cpp:148-159), zero on masked edges."""
    pi = poses[graph.edge_i]
    pj = poses[graph.edge_j]
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    ex = c * dx + s * dy - graph.measurements[:, 0]
    ey = -s * dx + c * dy - graph.measurements[:, 1]
    eth = se2.wrap_angle(pj[:, 2] - pi[:, 2] - graph.measurements[:, 2])
    e = torch.stack([ex, ey, eth], dim=-1)
    return torch.where(graph.edge_mask[:, None], e, 0.0)


def cost(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    e = residuals(graph, poses)
    return torch.sum(torch.einsum("ei,eij,ej->e", e, graph.precisions, e))


def _edge_jacobians(graph: PoseGraph, poses: torch.Tensor):
    """J0, J1 per edge [E, 3, 3] (spa2d.cpp:86-142)."""
    pi = poses[graph.edge_i]
    pj = poses[graph.edge_j]
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    # R0^T rows: [c, s; -s, c]; dR0^T/dth = [-s, c; -c, -s]
    j0 = torch.stack(
        [
            torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
            torch.stack([s, -c, -c * dx - s * dy], dim=-1),
            torch.stack([zero, zero, -one], dim=-1),
        ],
        dim=-2,
    )
    j1 = torch.stack(
        [
            torch.stack([c, s, zero], dim=-1),
            torch.stack([-s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return j0, j1


class _System(NamedTuple):
    j0: torch.Tensor  # [E, 3, 3]
    j1: torch.Tensor
    lj0: torch.Tensor  # [E, 3, 3] prec @ j0
    lj1: torch.Tensor
    g: torch.Tensor  # [N, 3] gradient J^T prec e
    diag: torch.Tensor  # [N, 3, 3] diagonal blocks of H
    free: torch.Tensor  # [N] bool — nodes that move


def _build_system(graph: PoseGraph, poses: torch.Tensor, n_fixed: int) -> _System:
    j0, j1 = _edge_jacobians(graph, poses)
    e = residuals(graph, poses)
    prec = torch.where(graph.edge_mask[:, None, None], graph.precisions, 0.0)
    lj0 = torch.einsum("eab,ebc->eac", prec, j0)
    lj1 = torch.einsum("eab,ebc->eac", prec, j1)

    n = poses.shape[0]
    le = torch.einsum("eab,eb->ea", prec, e)
    g = torch.zeros((n, 3), dtype=poses.dtype, device=poses.device)
    g.index_add_(0, graph.edge_i, torch.einsum("eba,eb->ea", j0, le))
    g.index_add_(0, graph.edge_j, torch.einsum("eba,eb->ea", j1, le))

    diag = torch.zeros((n, 3, 3), dtype=poses.dtype, device=poses.device)
    diag.index_add_(0, graph.edge_i, torch.einsum("eba,ebc->eac", j0, lj0))
    diag.index_add_(0, graph.edge_j, torch.einsum("eba,ebc->eac", j1, lj1))

    idx = torch.arange(n, device=poses.device)
    free = graph.node_mask & (idx >= n_fixed)
    return _System(j0, j1, lj0, lj1, g, diag, free)


def _hvp(graph: PoseGraph, sys: _System, lam, x: torch.Tensor) -> torch.Tensor:
    """(H + lam * blockdiag(H)) x, matrix-free over edges."""
    x = torch.where(sys.free[:, None], x, 0.0)
    xi = x[graph.edge_i]
    xj = x[graph.edge_j]
    # prec @ (J0 xi + J1 xj)
    ljx = torch.einsum("eab,eb->ea", sys.lj0, xi) + torch.einsum(
        "eab,eb->ea", sys.lj1, xj
    )
    out = torch.zeros_like(x)
    out.index_add_(0, graph.edge_i, torch.einsum("eba,eb->ea", sys.j0, ljx))
    out.index_add_(0, graph.edge_j, torch.einsum("eba,eb->ea", sys.j1, ljx))
    out = out + lam * torch.einsum("nab,nb->na", sys.diag, x)
    return torch.where(sys.free[:, None], out, 0.0)


def _block_inv(diag: torch.Tensor, free: torch.Tensor, lam) -> torch.Tensor:
    """Inverse of (1+lam)-augmented diagonal blocks; identity on fixed."""
    d = diag * (1.0 + lam)
    eye = torch.eye(3, dtype=diag.dtype, device=diag.device)
    d = torch.where(free[:, None, None], d + 1e-8 * eye, eye)
    return torch.linalg.inv(d)


def _pcg(
    graph: PoseGraph,
    sys: _System,
    lam,
    rhs: torch.Tensor,
    num_iters: int,
    tol: float,
) -> torch.Tensor:
    """Block-Jacobi PCG for (H + lam D) x = rhs (bpcg/bpcg.h:178-330 role)."""
    minv = _block_inv(sys.diag, sys.free, lam)
    rhs = torch.where(sys.free[:, None], rhs, 0.0)
    x = torch.zeros_like(rhs)
    r = rhs
    z = torch.einsum("nab,nb->na", minv, r)
    p = z
    rz = torch.sum(r * z)
    stop = tol * tol * torch.sum(rhs * rhs)
    for _ in range(num_iters):
        hp = _hvp(graph, sys, lam, p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        z = torch.einsum("nab,nb->na", minv, r)
        rzn = torch.sum(r * z)
        beta = rzn / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rzn
        if bool(torch.sum(r * r) < stop):
            break
    return x


class SolveStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    good_iters: int  # accepted LM steps
    final_lambda: torch.Tensor


def optimize(
    graph: PoseGraph,
    *,
    num_iters: int = 40,
    n_fixed: int = 1,
    cg_iters: int = 50,
    cg_tol: float = 1e-6,
    init_lambda: float = 1e-4,
    gauss_newton: bool = False,
) -> tuple[torch.Tensor, SolveStats]:
    """LM loop (doSPA, spa2d.cpp:425-609); returns optimized poses + stats.

    ``gauss_newton=True`` applies every step unconditionally and keeps
    lambda at ``init_lambda`` (the g2o adapter's
    OptimizationAlgorithmGaussNewton, g2o_solver.cc:42-138), which can
    diverge where LM's reject/escalate recovers."""
    poses = graph.poses
    cost0 = cost(graph, poses)
    cur_cost = cost0
    lam = torch.tensor(init_lambda, dtype=poses.dtype, device=poses.device)
    laminc = 2.0
    good = 0
    for _ in range(num_iters):
        sys = _build_system(graph, poses, n_fixed)
        dx = _pcg(graph, sys, lam, -sys.g, cg_iters, cg_tol)
        converged = bool(torch.sum(dx * dx) < 1e-16)
        new_poses = poses + dx
        new_poses = torch.cat(
            [new_poses[:, :2], se2.wrap_angle(new_poses[:, 2:3])], dim=1
        )
        new_cost = cost(graph, new_poses)
        accept = gauss_newton or bool(new_cost < cur_cost)
        if accept:
            poses, cur_cost = new_poses, new_cost
            good += 1
        if not gauss_newton:  # GN has no damping schedule
            if accept:
                lam = lam * 0.5
            else:
                lam = lam * laminc
                laminc *= 2.0
        if converged:
            break
    return poses, SolveStats(
        initial_cost=cost0,
        final_cost=cur_cost,
        good_iters=good,
        final_lambda=lam,
    )
