"""Float64 oracle of ``sba::SysSPA2d`` (2D sparse pose adjustment).

Reference: lesson6/lib/sparse_bundle_adjustment/src/spa2d.cpp — the only
backend the lesson actually uses (spa_solver.h:30,56).  Semantics preserved
exactly:

- node state (x, y, theta) with ``w2n = [R(th)^T | -R(th)^T t]``
  (spa2d.cpp:63-70) and ``dRdx = d(R^T)/dth`` (spa2d.cpp:76-81),
- constraint residual ``[R0^T (t1 - t0) - tmean; wrap1(th1 - th0 - amean)]``
  where the angle wrap is SINGLE-PASS (one +-2pi correction, calcErr
  spa2d.cpp:148-159),
- analytic Jacobians J0/J1 (spa2d.cpp:86-142),
- LM loop ``doSPA(niter=40, sLambda=1e-4)`` (spa2d.cpp:425-609 with the
  spa_solver.cc:50 call and spa2d.h:249 defaults):
  multiplicative diagonal augmentation ``H.diagonal() *= (1 + lambda)``,
  convergence on squared step norm < 1e-16, per-node update with
  single-pass angle normalization, accept (cost strictly decreased:
  lambda *= 0.5) / reject (lambda *= laminc, laminc *= 2, state reverted),
  gauge fixed by the first ``n_fixed=1`` node(s) (SysSPA2d ctor,
  spa2d.h:198).

The reference solves the sparse normal system with CSparse/CHOLMOD
Cholesky; the oracle solves the identical dense system with LAPACK — same
math, differences are double rounding only.
"""

from __future__ import annotations

import numpy as np


def _wrap1(a: float) -> float:
    """Single-pass angle wrap (spa2d.cpp:154-156): at most ONE +-2pi."""
    if a > np.pi:
        a -= 2.0 * np.pi
    if a < -np.pi:
        a += 2.0 * np.pi
    return a


class OracleSpa2d:
    """Scalar float64 port of SysSPA2d (addNode/addConstraint/doSPA)."""

    def __init__(self, n_fixed: int = 1, lambda0: float = 1.0e-4):
        self.n_fixed = n_fixed
        self.lam = lambda0
        self.node_ids: list[int] = []
        self.nodes: list[np.ndarray] = []  # [x, y, th] float64 each
        self.cons: list[tuple[int, int, np.ndarray, np.ndarray]] = []

    # ------------------------------------------------------------- build
    def add_node(self, pose, node_id: int) -> int:
        """spa2d.cpp:207-222."""
        self.node_ids.append(int(node_id))
        self.nodes.append(np.asarray(pose, np.float64).copy())
        return len(self.nodes) - 1

    def add_constraint(self, id0: int, id1: int, mean, prec) -> bool:
        """spa2d.cpp:230-252: ids resolved to node indices."""
        try:
            ni0 = self.node_ids.index(int(id0))
            ni1 = self.node_ids.index(int(id1))
        except ValueError:
            return False
        self.cons.append(
            (ni0, ni1, np.asarray(mean, np.float64).copy(),
             np.asarray(prec, np.float64).copy())
        )
        return True

    # ------------------------------------------------------------ pieces
    @staticmethod
    def _w2n_rot(th: float) -> np.ndarray:
        """2x2 R(th)^T (spa2d.cpp:63-70)."""
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, s], [-s, c]])

    @staticmethod
    def _drdx(th: float) -> np.ndarray:
        """d(R^T)/dth (spa2d.cpp:76-81)."""
        c, s = np.cos(th), np.sin(th)
        return np.array([[-s, c], [-c, -s]])

    def _err(self, con) -> np.ndarray:
        """calcErr (spa2d.cpp:148-159)."""
        ni0, ni1, mean, _ = con
        p0, p1 = self.nodes[ni0], self.nodes[ni1]
        e = np.empty(3)
        e[:2] = self._w2n_rot(p0[2]) @ (p1[:2] - p0[:2]) - mean[:2]
        e[2] = _wrap1((p1[2] - p0[2]) - mean[2])
        return e

    def _cost(self) -> float:
        """calcCost (spa2d.cpp:173-198): sum of err' prec err."""
        total = 0.0
        for con in self.cons:
            e = self._err(con)
            total += float(e @ con[3] @ e)
        return total

    def _jacobians(self, con):
        """setJacobians (spa2d.cpp:86-142)."""
        ni0, ni1, _, _ = con
        p0, p1 = self.nodes[ni0], self.nodes[ni1]
        rt = self._w2n_rot(p0[2])
        j0 = np.zeros((3, 3))
        j0[:2, :2] = -rt
        j0[:2, 2] = self._drdx(p0[2]) @ (p1[:2] - p0[:2])
        j0[2, 2] = -1.0
        j1 = np.zeros((3, 3))
        j1[:2, :2] = rt
        j1[2, 2] = 1.0
        return j0, j1

    def _setup_sys(self, s_lambda: float):
        """setupSys/setupSparseSys (spa2d.cpp:258-323, 328-413): assemble
        H and B over free nodes, then H.diagonal() *= (1 + s_lambda)."""
        n_free = len(self.nodes) - self.n_fixed
        h = np.zeros((3 * n_free, 3 * n_free))
        b = np.zeros(3 * n_free)
        for con in self.cons:
            ni0, ni1, _, prec = con
            j0, j1 = self._jacobians(con)
            e = self._err(con)
            i0 = ni0 - self.n_fixed
            i1 = ni1 - self.n_fixed
            if i0 >= 0:
                h[3 * i0 : 3 * i0 + 3, 3 * i0 : 3 * i0 + 3] += j0.T @ prec @ j0
                b[3 * i0 : 3 * i0 + 3] -= j0.T @ prec @ e
            if i1 >= 0:
                h[3 * i1 : 3 * i1 + 3, 3 * i1 : 3 * i1 + 3] += j1.T @ prec @ j1
                b[3 * i1 : 3 * i1 + 3] -= j1.T @ prec @ e
                if i0 >= 0:
                    m = j0.T @ prec @ j1
                    h[3 * i0 : 3 * i0 + 3, 3 * i1 : 3 * i1 + 3] += m
                    h[3 * i1 : 3 * i1 + 3, 3 * i0 : 3 * i0 + 3] += m.T
        h[np.diag_indices_from(h)] *= 1.0 + s_lambda
        return h, b

    # -------------------------------------------------------------- solve
    def do_spa(self, niter: int = 40, s_lambda: float = 1.0e-4) -> int:
        """doSPA (spa2d.cpp:425-609).  Returns the good-iteration count."""
        if self.n_fixed <= 0 or len(self.nodes) <= self.n_fixed:
            return 0
        if s_lambda > 0.0:
            self.lam = s_lambda
        laminc = 2.0
        lamdec = 0.5
        sq_min_delta = 1e-8 * 1e-8
        cost = self._cost()
        good_iter = 0
        for _ in range(niter):
            h, b = self._setup_sys(self.lam)
            try:
                delta = np.linalg.solve(h, b)
            except np.linalg.LinAlgError:
                break
            if float(delta @ delta) < sq_min_delta:
                break
            old = [p.copy() for p in self.nodes]
            for i in range(self.n_fixed, len(self.nodes)):
                d = delta[3 * (i - self.n_fixed) : 3 * (i - self.n_fixed) + 3]
                self.nodes[i][:2] += d[:2]
                self.nodes[i][2] = _wrap1(self.nodes[i][2] + d[2])
            newcost = self._cost()
            if newcost < cost:
                cost = newcost
                self.lam *= lamdec
                good_iter += 1
            else:
                self.lam *= laminc
                laminc *= 2.0
                self.nodes = old
        return good_iter

    def get_poses(self) -> dict[int, np.ndarray]:
        """SpaSolver::Compute correction extraction (spa_solver.cc:43-61)."""
        return {
            nid: self.nodes[i].copy() for i, nid in enumerate(self.node_ids)
        }
