"""2D pose-graph optimizer: Levenberg-Marquardt in float64
(counterpart of ``tpuslam/graph/solver.py``).

The residual model of the reference's SPA2d backend
(lesson6/lib/sparse_bundle_adjustment/src/spa2d.cpp):

- ``e = [R0^T (t1 - t0) - t_mean;  wrap(th1 - th0 - th_mean)]`` with a 3x3
  precision per edge (calcErr, spa2d.cpp:148-159),
- analytic Jacobians ``J0 = [-R0^T, dR0^T/dth (t1-t0); 0, -1]``,
  ``J1 = [R0^T, 0; 0, 1]`` (setJacobians, spa2d.cpp:86-142),
- LM: solve ``(H + lambda*diag(H)) dx = -g``, accept if the cost drops
  (lambda *= 0.5) else reject (lambda *= laminc, laminc *= 2),
  spa2d.cpp:555-582; converged when ``|dx|^2 < 1e-16``; the gauge is fixed
  by the first ``n_fixed`` nodes.

The whole solve is float64, as SPA's: the graph (poses, measurements,
precisions), the Jacobians, the LM state (poses, cost, lambda) and the
accept test, so that a cost decrease below f32 resolution is still taken
and a graph far from the origin keeps its sub-millimetre steps.

Each step's normal system is solved exactly, as SPA's CSparse Cholesky
solves it (spa2d.cpp:258-323), by one of two factors chosen from the
graph's padded node bucket (:func:`_pow2`) alike on every device:

- up to ``MAX_NODES``, dense: H is assembled whole and factored by
  Cholesky (:func:`_normal_matrix`, :func:`_step`), O(N^2) memory and
  O(N^3) time (``solve_scaling.py`` measures the buckets);
- past it, block-banded: H is assembled in the graph's reverse
  Cuthill-McKee order (``PoseGraph.order``) as K diagonal and K - 1
  sub-diagonal panels of ``panel`` nodes, which hold every edge of a
  chain with loop edges, and factored panel by panel
  (:func:`_band_matrix`, :func:`_band_step`), O(N P) memory and
  O(N P^2) time.  A graph without an order takes its natural order in
  one panel of its bucket: the dense factor, by the same code.

The JAX package's step, a block-Jacobi PCG of ``CG_ITERS`` iterations
(:func:`_pcg`), stops short of the exact step on a long loop (1.3 mm
from a 134-node closure's optimum; 356 m from the exact steps' poses on
a 16,384-pose garland); it is kept as that package's counterpart, off
the solve's path.

Plain PyTorch, no kernel: the JAX solver has no Pallas kernel either.

Every per-node sum (g, the diagonal blocks, the PCG's ``H x``) is a
gather of the per-edge-end terms through the graph's ``node_edges`` index
followed by a pairwise tree over its padded width (:func:`segment_sum`),
and each edge's off-diagonal block goes into H (dense or banded) by one
accumulating ``index_put_`` in edge order: a fixed order, so a solve
repeats itself bit for bit on the card, where a float ``index_add_`` adds
through atomics in an order that changes from run to run.

The index (``node_edges``, ``order``, ``panel``) is built on the host
from the graph's live edges by ``graph.backends.graph_from_edges``,
``convert.pose_graph_from_numpy`` and :func:`empty_graph`, each of which
records the edge arrays it was built from.  ``optimize`` takes any graph
the JAX package takes: one whose edge arrays are no longer those (a
``_replace`` of the edges, as the JAX package fills a graph, or an edit
in place, which bumps a tensor's version), or one built field by field
with no ``node_edges``, is indexed again from its edges first, at the
cost of one host read (``REPLAYS["reindex"]``).  The check itself reads
no tensor.

The loop is the reference's masked fixed-count form: LM carries a
``done`` flag on the device and freezes its state once done, and no
value is read back to the host (a factorization that fails gives a zero
step, which ends the solve as the reference's loop ends on a failed
solve).  On a CUDA device one LM iteration is captured once as a CUDA
graph for each padded (nodes, edges, node width, panel) bucket and
replayed ``num_iters`` times (:class:`_CudaSolve`).  On the CPU the same
iteration runs eagerly and stops at ``done``, where a read costs nothing
and the frozen iterations would change no value.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from tpuslam_torch.core import se2

# CUDA-graph replays (one a solve's LM iteration) and captures since the
# last reset, and the graphs ``optimize`` indexed again from their edges
REPLAYS = {"lm_step": 0, "captures": 0, "reindex": 0}


class PoseGraph(NamedTuple):
    """Pose graph as tensors (``node_mask``/``edge_mask`` gate padding)."""

    poses: torch.Tensor  # [N, 3] node estimates (x, y, theta)
    node_mask: torch.Tensor  # [N] bool — active nodes
    edge_i: torch.Tensor  # [E] int64 — source node (constraint frame)
    edge_j: torch.Tensor  # [E] int64 — target node
    measurements: torch.Tensor  # [E, 3] pose of j in i's frame
    precisions: torch.Tensor  # [E, 3, 3] information matrices
    edge_mask: torch.Tensor  # [E] bool — active edges
    # [N, D] int64: each live edge's ends as slots ``1 + 2k + end`` (end 0
    # for edge_i, 1 for edge_j), by edge index, padded with the zero slot
    # 0; D is a power of two (see graph.backends.node_edge_index); None
    # for a graph not indexed (the JAX package's seven fields), which
    # ``optimize`` indexes from its edges
    node_edges: torch.Tensor | None = None
    # [N] int64: each node's position in the band step's order
    # (graph.backends.band_order), None for the natural order
    order: torch.Tensor | None = None
    # the band step's panel width in nodes, a power of two that holds the
    # ordered half-bandwidth (graph.backends.band_panel); 0 for the whole
    # bucket
    panel: int = 0


def empty_graph(max_nodes: int, max_edges: int, dtype=torch.float64,
                device="cuda") -> PoseGraph:
    """A graph of ``max_nodes`` poses and ``max_edges`` edges, all masked
    off, on ``device``, float64 by default (the port's solve).

    Fill it as the JAX package's, with ``_replace``: its ``node_edges``
    (no edge end) is recorded for its masked-off edges, so ``optimize``
    indexes a graph whose edges were replaced or edited from those edges
    first (one host read).  ``graph.backends.graph_from_edges`` and
    ``convert.pose_graph_from_numpy`` build a graph with its index."""
    return mark_indexed(PoseGraph(
        poses=torch.zeros((max_nodes, 3), dtype=dtype, device=device),
        node_mask=torch.zeros(max_nodes, dtype=torch.bool, device=device),
        edge_i=torch.zeros(max_edges, dtype=torch.int64, device=device),
        edge_j=torch.zeros(max_edges, dtype=torch.int64, device=device),
        measurements=torch.zeros((max_edges, 3), dtype=dtype, device=device),
        precisions=torch.zeros((max_edges, 3, 3), dtype=dtype, device=device),
        edge_mask=torch.zeros(max_edges, dtype=torch.bool, device=device),
        node_edges=torch.zeros((max_nodes, 4), dtype=torch.int64,
                               device=device),
    ))


# the edge arrays each index was built from: ``node_edges`` -> (weak
# reference, version) of ``edge_i``, ``edge_j`` and ``edge_mask``
_INDEXED = WeakIdKeyDictionary()


def _edge_arrays(graph: PoseGraph):
    return graph.edge_i, graph.edge_j, graph.edge_mask


def _version(t: torch.Tensor) -> int | None:
    """``t``'s version counter; None for an inference tensor, which
    keeps none (an edit in place cannot be told)."""
    return None if t.is_inference() else t._version


def mark_indexed(graph: PoseGraph) -> PoseGraph:
    """Record that ``graph``'s index (``node_edges``, ``order``,
    ``panel``) was built from its edge arrays as they are now; returns
    ``graph``."""
    _INDEXED[graph.node_edges] = tuple(
        (weakref.ref(t), _version(t)) for t in _edge_arrays(graph))
    return graph


def is_indexed(graph: PoseGraph) -> bool:
    """Whether ``graph``'s index was built from its edge arrays as they
    are: the same tensors (a ``_replace`` of an edge array makes a new
    one) at the same version (an edit in place bumps it), and a row of
    ``node_edges`` for each node.  Edge arrays made under
    ``torch.inference_mode`` keep no version, so such a graph is never
    known to be indexed.  A host check: reads no tensor."""
    rec = (None if graph.node_edges is None
           else _INDEXED.get(graph.node_edges))
    return (rec is not None
            and graph.node_edges.shape[0] == graph.poses.shape[0]
            and all(ref() is t and version is not None
                    and version == _version(t)
                    for (ref, version), t in zip(rec, _edge_arrays(graph))))


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


def segment_sum(
    node_edges: torch.Tensor, t_i: torch.Tensor, t_j: torch.Tensor
) -> torch.Tensor:
    """Per-node sums of per-edge-end terms, in a fixed order.

    ``t_i`` / ``t_j`` [E, ...] are each edge's terms at its i and j end.
    Node n's sum is over the slots ``node_edges[n]`` (``1 + 2k + end``,
    slot 0 reads zero), added as a pairwise tree: slots (0, 1), (2, 3), ...
    first, then their sums pairwise, down to one.  Every add is an
    elementwise add in the terms' dtype (f64 in the solve), so the result
    is the same on any device."""
    terms = torch.stack([t_i, t_j], dim=1).reshape(-1, *t_i.shape[1:])
    terms = torch.cat([torch.zeros_like(terms[:1]), terms])
    out = terms[node_edges]  # [N, D, ...]
    while out.shape[1] > 1:
        out = out[:, 0::2] + out[:, 1::2]
    return out[:, 0]


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

    le = torch.einsum("eab,eb->ea", prec, e)
    g = segment_sum(graph.node_edges, torch.einsum("eba,eb->ea", j0, le),
                    torch.einsum("eba,eb->ea", j1, le))
    diag = segment_sum(graph.node_edges,
                       torch.einsum("eba,ebc->eac", j0, lj0),
                       torch.einsum("eba,ebc->eac", j1, lj1))

    idx = torch.arange(poses.shape[0], device=poses.device)
    free = graph.node_mask & (idx >= n_fixed)
    return _System(j0, j1, lj0, lj1, g, diag, free)


def _normal_matrix(graph: PoseGraph, sys: _System, lam) -> torch.Tensor:
    """[3N, 3N] float64: H with its diagonal times (1 + lam) (setupSys,
    spa2d.cpp:258-323).  The diagonal blocks are the per-node sums of
    ``_build_system``; each live edge between free nodes puts
    ``J0^T P J1`` at (i, j) and its transpose at (j, i), added in edge
    order.  Fixed and padded nodes get identity rows."""
    n = sys.g.shape[0]
    dev = sys.g.device
    free = sys.free
    keep = graph.edge_mask & free[graph.edge_i] & free[graph.edge_j]
    off = torch.einsum("eba,ebc->eac", sys.j0, sys.lj1)
    off = torch.where(keep[:, None, None], off, 0.0)
    k = torch.arange(3, device=dev)
    rows = (3 * graph.edge_i[:, None, None] + k[:, None]).expand_as(off)
    cols = (3 * graph.edge_j[:, None, None] + k).expand_as(off)
    h = torch.zeros((3 * n, 3 * n), dtype=sys.g.dtype, device=dev)
    h.index_put_((torch.cat([rows.reshape(-1), cols.reshape(-1)]),
                  torch.cat([cols.reshape(-1), rows.reshape(-1)])),
                 torch.cat([off.reshape(-1), off.reshape(-1)]),
                 accumulate=True)
    blocks = h.view(n, 3, n, 3).diagonal(dim1=0, dim2=2)  # [3, 3, N]
    diag = torch.where(free[:, None, None], sys.diag, 0.0)
    blocks.add_(diag.permute(1, 2, 0))
    d = h.diagonal()
    d.add_(d * lam + (1.0 - free.repeat_interleave(3).to(h.dtype)))
    return h


def _step(graph: PoseGraph, sys: _System, lam) -> torch.Tensor:
    """dx of ``_normal_matrix`` dx = -g, exactly: a Cholesky factor and two
    triangular solves (doSPA's CSparse solve, spa2d.cpp:425-609).  No
    value is read back: a factorization that fails leaves dx at 0."""
    n = sys.g.shape[0]
    h = _normal_matrix(graph, sys, lam)
    rhs = -(sys.g * sys.free[:, None]).reshape(3 * n, 1)
    chol, info = torch.linalg.cholesky_ex(h)
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    x = torch.where(info == 0, x, 0.0)
    return x.reshape(n, 3)


def _panel(graph: PoseGraph) -> int:
    """The band step's panel width in nodes: the graph's own, else its
    whole bucket (one panel, the dense factor)."""
    return graph.panel or _pow2(graph.poses.shape[0], 256)


def _positions(graph: PoseGraph) -> torch.Tensor:
    """[N] each node's position in the band step's order: the graph's
    own, else the natural order."""
    if graph.order is not None:
        return graph.order
    return torch.arange(graph.poses.shape[0], device=graph.poses.device)


def _band_matrix(graph: PoseGraph, sys: _System, lam, panel: int):
    """``_normal_matrix``'s H in the graph's order, as panels of ``panel``
    nodes: ([K, 3P, 3P] diagonal panels, [K - 1, 3P, 3P] sub-diagonal
    panels, H[k + 1, k]), K the panels that hold N nodes.  The same terms
    in the same order: each live edge between free nodes puts ``J0^T P
    J1`` at its (i, j) and the transpose at (j, i), all by one
    accumulating ``index_put_`` in edge order (the entries above the
    diagonal panels go to slots that are dropped); then the diagonal
    blocks and the damping.  Fixed nodes and the positions past N get
    identity rows.  Each stored entry equals the dense H's bit for bit."""
    n = sys.g.shape[0]
    dev = sys.g.device
    w = 3 * panel
    k = -(-n // panel)
    pos = _positions(graph)
    free = sys.free
    keep = graph.edge_mask & free[graph.edge_i] & free[graph.edge_j]
    off = torch.einsum("eba,ebc->eac", sys.j0, sys.lj1)
    off = torch.where(keep[:, None, None], off, 0.0)
    c = torch.arange(3, device=dev)
    rows = (3 * pos[graph.edge_i][:, None, None] + c[:, None]).expand_as(off)
    cols = (3 * pos[graph.edge_j][:, None, None] + c).expand_as(off)
    r = torch.cat([rows.reshape(-1), cols.reshape(-1)])
    s = torch.cat([cols.reshape(-1), rows.reshape(-1)])
    pr, pc = r // w, s // w
    local = (r % w) * w + s % w
    # an entry above the diagonal panels goes to a slot of its own past
    # the panels: a shared one would be one long run of sums in the
    # deterministic scatter
    slot = torch.where(pr == pc, pr * w * w + local,
                       torch.where(pr == pc + 1, (k + pc) * w * w + local,
                                   (2 * k - 1) * w * w
                                   + torch.arange(r.shape[0], device=dev)))
    band = torch.zeros((2 * k - 1) * w * w + r.shape[0], dtype=sys.g.dtype,
                       device=dev)
    band.index_put_((slot,), torch.cat([off.reshape(-1), off.reshape(-1)]),
                    accumulate=True)
    diag_p = band[:k * w * w].view(k, w, w)
    sub_p = band[k * w * w:(2 * k - 1) * w * w].view(k - 1, w, w)
    blocks = torch.zeros((k * panel, 3, 3), dtype=sys.g.dtype, device=dev)
    blocks[pos] = torch.where(free[:, None, None], sys.diag, 0.0)
    free_p = torch.zeros(k * panel, dtype=sys.g.dtype, device=dev)
    free_p[pos] = free.to(sys.g.dtype)
    diag_p.view(k, panel, 3, panel, 3).diagonal(dim1=1, dim2=3).add_(
        blocks.view(k, panel, 3, 3).permute(0, 2, 3, 1))
    d = diag_p.diagonal(dim1=1, dim2=2)
    d.add_(d * lam + (1.0 - free_p.repeat_interleave(3).view(k, w)))
    return diag_p, sub_p


def _band_step(graph: PoseGraph, sys: _System, lam, panel: int
               ) -> torch.Tensor:
    """dx of ``_normal_matrix`` dx = -g, exactly, by a block-tridiagonal
    Cholesky factor of :func:`_band_matrix`'s panels (A_kk -= L_k,k-1
    L_k,k-1^T, L_kk = chol(A_kk), L_k+1,k = A_k+1,k L_kk^-T), a forward
    and a backward block substitution, and the graph's order undone.  A
    fixed count of panel ops and no value read back: a panel whose
    factorization fails leaves dx at 0."""
    diag_p, sub_p = _band_matrix(graph, sys, lam, panel)
    k, w = diag_p.shape[0], diag_p.shape[1]
    pos = _positions(graph)
    rhs = torch.zeros((k * panel, 3), dtype=sys.g.dtype, device=sys.g.device)
    rhs[pos] = -(sys.g * sys.free[:, None])
    rhs = rhs.view(k, w, 1)
    chol, info = torch.linalg.cholesky_ex(diag_p[0])
    lows, offs, infos = [chol], [], [info]
    for i in range(1, k):
        off = torch.linalg.solve_triangular(lows[-1].mT, sub_p[i - 1],
                                            upper=True, left=False)
        chol, info = torch.linalg.cholesky_ex(
            torch.addmm(diag_p[i], off, off.mT, alpha=-1.0))
        lows.append(chol)
        offs.append(off)
        infos.append(info)
    ys = [torch.linalg.solve_triangular(lows[0], rhs[0], upper=False)]
    for i in range(1, k):
        ys.append(torch.linalg.solve_triangular(
            lows[i], torch.addmm(rhs[i], offs[i - 1], ys[-1], alpha=-1.0),
            upper=False))
    xs = [torch.linalg.solve_triangular(lows[-1].mT, ys[-1], upper=True)]
    for i in range(k - 2, -1, -1):
        xs.append(torch.linalg.solve_triangular(
            lows[i].mT, torch.addmm(ys[i], offs[i].mT, xs[-1], alpha=-1.0),
            upper=True))
    x = torch.cat(xs[::-1]).view(k * panel, 3)[pos]
    return torch.where((torch.stack(infos) == 0).all(), x, 0.0)


def _hvp(graph: PoseGraph, sys: _System, lam, x: torch.Tensor) -> torch.Tensor:
    """(H + lam * blockdiag(H)) x, matrix-free over edges (the JAX
    package's ``_hvp``), its per-node sums by ``segment_sum``."""
    x = torch.where(sys.free[:, None], x, 0.0)
    xi = x[graph.edge_i]
    xj = x[graph.edge_j]
    # prec @ (J0 xi + J1 xj)
    ljx = (torch.einsum("eab,eb->ea", sys.lj0, xi)
           + torch.einsum("eab,eb->ea", sys.lj1, xj))
    out = segment_sum(graph.node_edges,
                      torch.einsum("eba,eb->ea", sys.j0, ljx),
                      torch.einsum("eba,eb->ea", sys.j1, ljx))
    out = out + lam * torch.einsum("nab,nb->na", sys.diag, x)
    return torch.where(sys.free[:, None], out, 0.0)


def _inv3(d: torch.Tensor) -> torch.Tensor:
    """Inverses of [N, 3, 3] blocks by the adjugate: elementwise only, so
    no pivoting, no solver library and no host check of the result (the
    blocks are symmetric positive definite, or the identity)."""
    a, b, c = d[:, 0, 0], d[:, 0, 1], d[:, 0, 2]
    e, f, g = d[:, 1, 0], d[:, 1, 1], d[:, 1, 2]
    h, i, k = d[:, 2, 0], d[:, 2, 1], d[:, 2, 2]
    c00 = f * k - g * i
    c01 = g * h - e * k
    c02 = e * i - f * h
    det = a * c00 + b * c01 + c * c02
    adj = torch.stack([
        torch.stack([c00, c * i - b * k, b * g - c * f], dim=-1),
        torch.stack([c01, a * k - c * h, c * e - a * g], dim=-1),
        torch.stack([c02, b * h - a * i, a * f - b * e], dim=-1),
    ], dim=-2)
    return adj / det[:, None, None]


def _pcg(graph: PoseGraph, sys: _System, lam, early_exit: bool
         ) -> torch.Tensor:
    """dx of (H + lam D) dx = -g by block-Jacobi PCG (the JAX package's
    ``_pcg``, the role of bpcg/bpcg.h:178-330): ``CG_ITERS`` masked
    iterations that freeze once the residual is below ``CG_TOL`` of the
    right-hand side's; with ``early_exit`` the loop reads ``done`` and
    stops there instead, which changes no value."""
    eye = torch.eye(3, dtype=sys.diag.dtype, device=sys.diag.device)
    minv = _inv3(torch.where(sys.free[:, None, None],
                             sys.diag * (1.0 + lam) + 1e-8 * eye, eye))
    rhs = torch.where(sys.free[:, None], -sys.g, 0.0)
    x = torch.zeros_like(rhs)
    r = rhs
    z = torch.einsum("nab,nb->na", minv, r)
    p = z
    rz = torch.sum(r * z)
    stop = CG_TOL * CG_TOL * torch.sum(rhs * rhs)
    done = torch.zeros((), dtype=torch.bool, device=rhs.device)
    for _ in range(CG_ITERS):
        hp = _hvp(graph, sys, lam, p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
        xn = x + alpha * p
        rn = r - alpha * hp
        zn = torch.einsum("nab,nb->na", minv, rn)
        rzn = torch.sum(rn * zn)
        beta = rzn / torch.clamp_min(rz, 1e-30)
        pn = zn + beta * p
        new_done = done | (torch.sum(rn * rn) < stop)
        x = torch.where(done, x, xn)
        r = torch.where(done, r, rn)
        p = torch.where(done, p, pn)
        rz = torch.where(done, rz, rzn)
        done = new_done
        if early_exit and bool(done):
            break
    return x


class SolveStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    good_iters: torch.Tensor  # [] int32 — accepted LM steps
    final_lambda: torch.Tensor


class _LmState(NamedTuple):
    poses: torch.Tensor  # [N, 3] float64
    cost: torch.Tensor  # [] float64
    lam: torch.Tensor  # [] float64
    laminc: torch.Tensor  # [] float64
    good: torch.Tensor  # [] int32
    done: torch.Tensor  # [] bool


def _init_state(graph: PoseGraph, init_lambda: float) -> _LmState:
    poses = graph.poses
    return _LmState(
        poses=poses,
        cost=cost(graph, poses),
        lam=torch.full((), init_lambda, dtype=poses.dtype, device=poses.device),
        laminc=torch.full((), 2.0, dtype=poses.dtype, device=poses.device),
        good=torch.zeros((), dtype=torch.int32, device=poses.device),
        done=torch.zeros((), dtype=torch.bool, device=poses.device),
    )


def _lm_step(
    graph: PoseGraph,
    st: _LmState,
    n_fixed: int,
    gauss_newton: bool,
    step: str,
    early_exit: bool = False,
) -> _LmState:
    """One masked LM iteration (doSPA's loop body, spa2d.cpp:425-609):
    every update is ``torch.where``-selected and frozen once ``done``.
    ``step`` names the step solve (:func:`_step_kind`): ``"dense"``
    (:func:`_step`), ``"band"`` (:func:`_band_step`) or the JAX
    package's ``"pcg"`` (:func:`_pcg`, which ``early_exit`` lets stop at
    its ``done``; off the solve's path)."""
    sys = _build_system(graph, st.poses, n_fixed)
    if step == "dense":
        dx = _step(graph, sys, st.lam)
    elif step == "band":
        dx = _band_step(graph, sys, st.lam, _panel(graph))
    else:
        dx = _pcg(graph, sys, st.lam, early_exit)
    converged = torch.sum(dx * dx) < 1e-16
    new_poses = st.poses + dx
    new_poses = torch.cat(
        [new_poses[:, :2], se2.wrap_angle(new_poses[:, 2:3])], dim=1
    )
    new_cost = cost(graph, new_poses)
    if gauss_newton:  # every step taken, no damping schedule
        accept = torch.ones((), dtype=torch.bool, device=st.done.device)
        lam_n, laminc_n = st.lam, st.laminc
    else:
        accept = new_cost < st.cost
        lam_n = torch.where(accept, st.lam * 0.5, st.lam * st.laminc)
        laminc_n = torch.where(accept, st.laminc, st.laminc * 2.0)
    poses_n = torch.where(accept, new_poses, st.poses)
    cost_n = torch.where(accept, new_cost, st.cost)
    good_n = st.good + accept.to(torch.int32)
    done = st.done
    return _LmState(
        poses=torch.where(done, st.poses, poses_n),
        cost=torch.where(done, st.cost, cost_n),
        lam=torch.where(done, st.lam, lam_n),
        laminc=torch.where(done, st.laminc, laminc_n),
        good=torch.where(done, st.good, good_n),
        done=done | converged,
    )


def _solve(
    graph: PoseGraph,
    num_iters: int,
    n_fixed: int,
    init_lambda: float,
    gauss_newton: bool,
    early_exit: bool,
) -> tuple[torch.Tensor, SolveStats]:
    """The LM loop run eagerly on the graph's device, with the step solve
    of its bucket (:func:`_step_kind`); ``early_exit`` reads the ``done``
    flags and stops at them (the CPU's form), otherwise every iteration
    runs, masked, with no host read."""
    step = _step_kind(graph.poses.shape[0])
    st = _init_state(graph, init_lambda)
    cost0 = st.cost
    for _ in range(num_iters):
        st = _lm_step(graph, st, n_fixed, gauss_newton, step, early_exit)
        if early_exit and bool(st.done):
            break
    return st.poses, SolveStats(cost0, st.cost, st.good, st.lam)


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << max(0, (max(n, 1) - 1).bit_length()))


# the largest padded node bucket whose steps take the dense factor: the
# f64 H and its factor take 144 N^2 bytes, 9.7 GB at 8192 nodes; a larger
# bucket takes the band factor, 144 N P bytes (P the panel width)
MAX_NODES = 8192
# the JAX package's PCG: its iterations and relative residual (the JAX
# presets' cg_iters, tpuslam/graph/backends.py, and optimize's cg_tol)
CG_ITERS = 60
CG_TOL = 1e-6


def _dense(n: int) -> bool:
    """Whether a graph of ``n`` nodes takes the dense step: its padded
    bucket (the card's capture bucket, at least 256 nodes) is at most
    ``MAX_NODES``.  Both devices decide alike."""
    return _pow2(n, 256) <= MAX_NODES


def _step_kind(n: int) -> str:
    """The step solve of a graph of ``n`` nodes: ``"dense"`` up to
    ``MAX_NODES`` (:func:`_dense`), ``"band"`` past it."""
    return "dense" if _dense(n) else "band"


class _CudaSolve:
    """One LM iteration as a CUDA graph over static, padded buffers.

    The bucket is (nodes, edges, node width) padded to powers of two with
    masks, at least 256 nodes and 512 edges as the reference's
    ``graph_from_edges`` pads, with the step solve and (for the band step)
    the panel width; padded nodes have no edge ends and padded edges no
    mask, so they change no value, and they take the last positions of
    the order.  A solve copies its graph into the buffers, sets the LM
    state and replays the graph ``num_iters`` times; the captured
    iteration writes its new state over the old."""

    def __init__(self, cap_n, cap_e, width, step, panel, device, n_fixed,
                 gauss_newton):
        f64 = dict(dtype=torch.float64, device=device)
        self.graph = PoseGraph(
            poses=torch.zeros((cap_n, 3), **f64),
            node_mask=torch.zeros(cap_n, dtype=torch.bool, device=device),
            edge_i=torch.zeros(cap_e, dtype=torch.int64, device=device),
            edge_j=torch.zeros(cap_e, dtype=torch.int64, device=device),
            measurements=torch.zeros((cap_e, 3), **f64),
            precisions=torch.zeros((cap_e, 3, 3), **f64),
            edge_mask=torch.zeros(cap_e, dtype=torch.bool, device=device),
            node_edges=torch.zeros((cap_n, width), dtype=torch.int64,
                                   device=device),
            order=torch.arange(cap_n, device=device),
            panel=panel,
        )
        self.natural = torch.arange(cap_n, device=device)
        self.state = _init_state(self.graph, 0.0)
        args = (n_fixed, gauss_newton, step)

        def step():
            new = _lm_step(self.graph, self.state, *args)
            for buf, val in zip(self.state, new):
                buf.copy_(val)

        # warm up on a side stream, then capture (torch.cuda.graphs)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        self.cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.cuda_graph):
            step()
        REPLAYS["captures"] += 1

    def run(self, graph: PoseGraph, num_iters: int, init_lambda: float):
        """Copy ``graph`` in, replay; returns (poses [n, 3], stats)."""
        for buf, src in zip(self.graph[:8], graph[:8]):
            k = src.shape[0]
            buf[:k].copy_(src)
            buf[k:].zero_()
        n = graph.poses.shape[0]
        self.graph.order.copy_(self.natural)
        if graph.order is not None:
            self.graph.order[:n].copy_(graph.order)
        st = self.state
        st.poses.copy_(self.graph.poses)
        st.cost.copy_(cost(self.graph, self.graph.poses))
        st.lam.fill_(init_lambda)
        st.laminc.fill_(2.0)
        st.good.zero_()
        st.done.zero_()
        cost0 = st.cost.clone()
        for _ in range(num_iters):
            self.cuda_graph.replay()
        REPLAYS["lm_step"] += num_iters
        return st.poses[:n].clone(), SolveStats(
            cost0, st.cost.clone(), st.good.clone(), st.lam.clone())


# captured solves by (device, bucket, step solve, panel width, solver
# settings): a mapping session meets a handful of buckets as its graph
# grows
_CUDA_SOLVES: dict[tuple, _CudaSolve] = {}


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
    diverge where LM's reject/escalate recovers.

    Returns float64 poses.  Every step is exact; its factor follows the
    graph's padded bucket (:func:`_step_kind`): dense up to
    ``MAX_NODES``, banded in the graph's order past it.  On a CUDA device
    the solve replays the captured LM iteration of the graph's bucket and
    reads nothing back; on the CPU it runs eagerly and stops at
    convergence.

    ``cg_iters`` and ``cg_tol`` bound the JAX package's PCG step; they are
    taken, so that its call forms work, and change nothing: the exact
    step has no iterations to bound.

    A graph whose index is not that of its edges (:func:`is_indexed`) is
    indexed from them first, with one host read."""
    if not is_indexed(graph):
        from tpuslam_torch.graph.backends import index_graph  # imports us

        REPLAYS["reindex"] += 1
        graph = index_graph(graph)
    dev = graph.poses.device
    n, e = graph.poses.shape[0], graph.edge_i.shape[0]
    if dev.type != "cuda":
        return _solve(graph, num_iters, n_fixed, init_lambda, gauss_newton,
                      True)
    step = _step_kind(n)
    key = (str(dev), _pow2(n, 256), _pow2(e, 512), graph.node_edges.shape[1],
           step, _panel(graph) if step == "band" else 0, n_fixed,
           gauss_newton)
    solve = _CUDA_SOLVES.get(key)
    if solve is None:
        solve = _CUDA_SOLVES[key] = _CudaSolve(*key[1:6], dev, *key[6:])
    return solve.run(graph, num_iters, init_lambda)
