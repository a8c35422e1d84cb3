"""Ullmann subgraph isomorphism: vectorized pieces + the serial baseline.

The vectorized refinement/feasibility used inside the PSO loop lives in
``repro_torch.kernels`` (ops/ref). This module adds:

  * ``serial_ullmann`` — the classic depth-first backtracking Ullmann with
    per-level refinement. This is the *IsoSched-like baseline*: it is what a
    CPU-serialized TSS scheduler runs, and its step count feeds the latency
    model of the baseline scheduler in ``repro_torch.sched``.
  * ``count_monomorphisms`` — exhaustive oracle for tests (small graphs).

Numpy copy of the JAX package's ``core/ullmann.py``; the port keeps its own
copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SerialStats:
    """Work counters: the baseline cost model charges these."""
    nodes_visited: int = 0          # search-tree nodes
    refine_sweeps: int = 0          # refinement passes
    mac_ops: int = 0                # multiply-accumulate ops in refinement


def _refine_np(M: np.ndarray, Q: np.ndarray, G: np.ndarray,
               stats: Optional[SerialStats] = None) -> np.ndarray:
    """Fixpoint refinement, numpy (serial semantics, same math as ref.py)."""
    Qi = Q.astype(np.int64)
    Gi = G.astype(np.int64)
    M = M.astype(np.int64)
    n, m = M.shape
    while True:
        support_out = M @ Gi.T
        support_in = M @ Gi
        viol = Qi @ (support_out == 0) + Qi.T @ (support_in == 0)
        M2 = M * (viol == 0)
        if stats is not None:
            stats.refine_sweeps += 1
            stats.mac_ops += 2 * n * m * m + 2 * n * n * m
        if (M2 == M).all():
            return M2
        M = M2


def serial_ullmann(Q: np.ndarray, G: np.ndarray, mask: np.ndarray,
                   max_solutions: int = 1,
                   stats: Optional[SerialStats] = None
                   ) -> List[np.ndarray]:
    """Classic recursive Ullmann (directed monomorphism).

    Returns up to ``max_solutions`` assignment matrices. ``stats`` (if
    given) accumulates the serial work — the quantity IMMSched removes from
    the critical path.
    """
    n, m = mask.shape
    if stats is None:
        stats = SerialStats()
    M0 = _refine_np(mask.copy(), Q, G, stats)
    solutions: List[np.ndarray] = []
    used = np.zeros(m, dtype=bool)
    assign = np.full(n, -1, dtype=np.int64)

    # order rows by fewest candidates first (standard Ullmann ordering)
    order = np.argsort(M0.sum(axis=1))

    def backtrack(depth: int, M: np.ndarray) -> bool:
        stats.nodes_visited += 1
        if depth == n:
            sol = np.zeros((n, m), dtype=np.uint8)
            for i in range(n):
                sol[i, assign[i]] = 1
            solutions.append(sol)
            return len(solutions) >= max_solutions
        i = order[depth]
        for j in range(m):
            if M[i, j] and not used[j]:
                M2 = M.copy()
                M2[i, :] = 0
                M2[:, j] = 0
                M2[i, j] = 1
                M2 = _refine_np(M2, Q, G, stats)
                if (M2.sum(axis=1) == 0).any():
                    continue
                used[j] = True
                assign[i] = j
                if backtrack(depth + 1, M2):
                    return True
                used[j] = False
                assign[i] = -1
        return False

    if not (M0.sum(axis=1) == 0).any():
        backtrack(0, M0)
    return solutions


def count_monomorphisms(Q: np.ndarray, G: np.ndarray,
                        mask: Optional[np.ndarray] = None,
                        limit: int = 10_000) -> int:
    """Exhaustive count (test oracle, n ≤ ~8)."""
    n, m = Q.shape[0], G.shape[0]
    if mask is None:
        mask = np.ones((n, m), dtype=np.uint8)
    count = 0

    def rec(i: int, used: int, assign: List[int]) -> None:
        nonlocal count
        if count >= limit:
            return
        if i == n:
            count += 1
            return
        for j in range(m):
            if not mask[i, j] or (used >> j) & 1:
                continue
            ok = True
            for u in range(i):
                if Q[i, u] and not G[j, assign[u]]:
                    ok = False
                    break
                if Q[u, i] and not G[assign[u], j]:
                    ok = False
                    break
            if ok:
                rec(i + 1, used | (1 << j), assign + [j])

    rec(0, 0, [])
    return count
