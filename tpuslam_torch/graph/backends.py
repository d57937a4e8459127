"""Pose-graph solver backends: the reference's ScanSolver seam
(counterpart of ``tpuslam/graph/backends.py``).

The reference ships four backends behind ``karto::ScanSolver``
(Mapper.h:825-891), selected by ``solver_type`` (karto_slam.cc:254-284).
They minimise the same residual and differ in iteration strategy, so one
float64 engine (``graph/solver.py``) serves them all, each step solved
exactly by a Cholesky factorization as the reference's backends factor
theirs: dense up to ``solver.MAX_NODES`` nodes, block-banded in the
reverse Cuthill-McKee order of :func:`graph_from_edges` past it:

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

from tpuslam_torch.graph.solver import (
    PoseGraph,
    SolveStats,
    mark_indexed,
    optimize,
)


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
        self.cg_iters = cg_iters  # passed on; the exact step has no use
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


def node_edge_index(n: int, edge_i: np.ndarray, edge_j: np.ndarray,
                    edges: np.ndarray | None = None) -> np.ndarray:
    """[n, D] int64: node v's edge ends as slots ``1 + 2k + end`` (end 0
    at ``edge_i``, 1 at ``edge_j`` of edge k), sorted by edge index,
    padded with the zero slot 0 to D, the power of two (at least 4) that
    holds the largest degree.  ``edges`` gives each pair's edge index in
    the graph (by default its place in the lists: every edge live).  The
    solver's per-node sums read this order (``graph.solver.segment_sum``)."""
    e = len(edge_i)
    node = np.empty(2 * e, np.int64)
    node[0::2] = edge_i
    node[1::2] = edge_j
    k = np.arange(e, dtype=np.int64) if edges is None else np.asarray(
        edges, np.int64)
    slot = (1 + 2 * k[:, None] + np.arange(2)).reshape(-1)
    order = np.lexsort((slot, node))  # by node, then by slot
    node, slot = node[order], slot[order]
    deg = np.bincount(node, minlength=n)
    width = 4
    while width < (deg.max() if n else 0):
        width *= 2
    start = np.concatenate([[0], np.cumsum(deg)[:-1]]) if n else deg
    out = np.zeros((n, width), np.int64)
    out[node, np.arange(2 * e) - start[node]] = slot
    return out


def band_order(n: int, edge_i: np.ndarray, edge_j: np.ndarray
               ) -> np.ndarray:
    """[n] int64: each node's position in the reverse Cuthill-McKee order
    of the graph, which keeps its edges near the diagonal of H.

    The connected components are taken in the order of their nodes of
    least (degree, index); each is walked breadth first from a
    pseudo-peripheral node (George and Liu: from that node, then from the
    least-degree node of the walk's last level while that lengthens the
    walk), each node's unvisited neighbours taken by (degree, index); the
    whole walk is then reversed.  Ties go to the lower index, so the order
    depends on the edge list alone."""
    a = np.concatenate([edge_i, edge_j]).astype(np.int64)
    b = np.concatenate([edge_j, edge_i]).astype(np.int64)
    key = np.unique((a * n + b)[a != b])
    a, b = key // max(n, 1), key % max(n, 1)
    deg = np.bincount(a, minlength=n)
    nbrs = b[np.lexsort((b, deg[b], a))].tolist()
    start = np.concatenate([[0], np.cumsum(deg)]).tolist()
    degree = deg.tolist()
    stamp, level = [0] * n, [0] * n
    walks = 0

    def walk(root):
        """The nodes by a breadth-first walk from ``root``; ``level``
        holds their depths until the next walk."""
        nonlocal walks
        walks += 1
        stamp[root], level[root] = walks, 0
        out = [root]
        for v in out:
            depth = level[v] + 1
            for u in nbrs[start[v]:start[v + 1]]:
                if stamp[u] != walks:
                    stamp[u], level[u] = walks, depth
                    out.append(u)
        return out

    seen = [False] * n
    walked = []
    for root in np.lexsort((np.arange(n), deg)).tolist():
        if seen[root]:
            continue
        comp = walk(root)
        while True:
            depth, last = level[comp[-1]], len(comp) - 1
            while last and level[comp[last - 1]] == depth:
                last -= 1
            cand = min(comp[last:], key=lambda u: (degree[u], u))
            nxt = walk(cand)
            if level[nxt[-1]] <= depth:
                break
            comp = nxt
        for u in comp:
            seen[u] = True
        walked.extend(comp)
    pos = np.empty(n, np.int64)
    pos[np.asarray(walked[::-1], np.int64)] = np.arange(n, dtype=np.int64)
    return pos


def band_panel(pos: np.ndarray, edge_i: np.ndarray, edge_j: np.ndarray
               ) -> int:
    """The band step's panel width in nodes under the order ``pos``: the
    smallest power of two, at least 8, that holds the half-bandwidth (the
    largest ``|pos[i] - pos[j]|`` of an edge), so that every edge joins
    two nodes of one panel or of two neighbouring panels."""
    width = int(np.abs(pos[edge_i] - pos[edge_j]).max()) if len(edge_i) else 0
    return max(8, 1 << max(0, (width - 1).bit_length()))


def index_from_edges(n: int, edge_i: np.ndarray, edge_j: np.ndarray,
                     live: np.ndarray, device) -> dict:
    """The solver's index of a graph of ``n`` nodes, built on the host
    from its live edges: each node's edge ends (:func:`node_edge_index`),
    every node's position in the band step's order (:func:`band_order`)
    and that order's panel width (:func:`band_panel`)."""
    k = np.flatnonzero(live)
    ei, ej = edge_i[k].astype(np.int64), edge_j[k].astype(np.int64)
    ends = np.concatenate([ei, ej])
    if ends.size and not (0 <= ends.min() and ends.max() < n):
        raise ValueError(f"a live edge joins a node outside [0, {n})")
    pos = band_order(n, ei, ej)
    return dict(
        node_edges=torch.as_tensor(node_edge_index(n, ei, ej, k),
                                   device=device),
        order=torch.as_tensor(pos, device=device),
        panel=band_panel(pos, ei, ej),
    )


def index_graph(graph: PoseGraph) -> PoseGraph:
    """``graph`` with the solver's index built from its own live edges,
    on its device, and recorded as theirs (``graph.solver.is_indexed``):
    one host read of ``edge_i``, ``edge_j`` and ``edge_mask``.  A live
    edge that joins a node outside the graph raises ValueError."""
    ends = torch.stack([graph.edge_i.to(torch.int64),
                        graph.edge_j.to(torch.int64),
                        graph.edge_mask.to(torch.int64)]).cpu().numpy()
    return mark_indexed(graph._replace(**index_from_edges(
        graph.poses.shape[0], ends[0], ends[1], ends[2].astype(bool),
        graph.poses.device)))


def graph_from_edges(
    poses: np.ndarray,
    edges: list[tuple[int, int, np.ndarray, np.ndarray]],
    min_nodes: int = 256,
    min_edges: int = 512,
    *,
    device="cuda",
) -> PoseGraph:
    """A padded float64 PoseGraph on ``device`` from host-side pose/edge
    lists, with the solver's index (each node's edge ends, the band
    step's order and its panel width; :func:`node_edge_index`,
    :func:`band_order`, :func:`band_panel`) built once here on the host.

    The capacities are the JAX package's: powers of two, at least 16 and
    at least ``min_nodes`` / ``min_edges``, the padding masked off (zero
    poses and edges).  The first n rows of the solved poses are the n
    poses'.  On a CUDA device
    ``optimize`` copies the graph into the static buffers of its bucket
    (powers of two, at least 256 nodes and 512 edges, as the defaults
    pad), so that the captured LM iteration of that bucket serves every
    graph in it."""
    n, e = len(poses), len(edges)
    cap_n = max(min_nodes, 1 << max(4, (max(n, 1) - 1).bit_length()))
    cap_e = max(min_edges, 1 << max(4, (max(e, 1) - 1).bit_length()))
    p = np.zeros((cap_n, 3), np.float64)
    p[:n] = np.asarray(poses[:n], np.float64).reshape(n, 3)
    node_mask = np.arange(cap_n) < n
    edge_i = np.zeros(cap_e, np.int64)
    edge_j = np.zeros(cap_e, np.int64)
    meas = np.zeros((cap_e, 3), np.float64)
    prec = np.zeros((cap_e, 3, 3), np.float64)
    edge_mask = np.arange(cap_e) < e
    if e:
        edge_i[:e] = [x[0] for x in edges]
        edge_j[:e] = [x[1] for x in edges]
        meas[:e] = np.asarray([x[2] for x in edges],
                              np.float64).reshape(e, 3)
        prec[:e] = np.asarray([x[3] for x in edges],
                              np.float64).reshape(e, 3, 3)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return mark_indexed(PoseGraph(
        poses=dev(p),
        node_mask=dev(node_mask),
        edge_i=dev(edge_i),
        edge_j=dev(edge_j),
        measurements=dev(meas),
        precisions=dev(prec),
        edge_mask=dev(edge_mask),
        **index_from_edges(cap_n, edge_i, edge_j, edge_mask, device),
    ))
