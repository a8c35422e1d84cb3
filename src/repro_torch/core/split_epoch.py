"""The split (pre-fusion) swarm epoch of ONE problem, one seam call a step.

Before the fused epoch kernels, an epoch dispatched each step's kernels
on its own: per inner step ``pso_update`` → the optional requantize →
the fitness → the local and global bests, and after the K steps an
epilogue of loose projections, Ullmann sweeps, feasibility checks, a
fitness recompute and the elite consensus. This module is that path on
tensors, written against the kernel seam (``KernelBackend``), so on the
``cuda`` suite it runs the hand-written kernels for ``pso_update``,
``ullmann_refine_step`` and ``greedy_project`` (and the fitness) between
torch ops. Its JAX counterparts are in ``benchmarks/bench_epoch.py``:

  * ``loose_epoch`` — ``_make_loose_fn`` (the K-step loose scan);
  * ``split_tail``  — ``_make_split_tail_fn`` (τ = 0, as there);
  * ``split_epoch`` — the two in turn, as ``bench_e2e`` composes them.

On the same inputs the split epoch equals the fused one
(``KernelBackend.epoch_fused`` → ``epoch_finish`` at τ = 0): the loose
scan's outputs and the recomputed fitness bit for bit, M̂ and the
feasibility flags exactly, S̄ to float32 rounding (another summation
order of the elite consensus).
"""
from __future__ import annotations

import torch

from repro_torch.core import pso
from repro_torch.kernels import backend as kernel_backend


def loose_epoch(S, V, S_local, f_local, S_star, f_star, S_bar, mask, Q, G,
                r_all, cfg: pso.PSOConfig):
    """K inner steps, one seam call each: ``S``/``V``/``S_local``
    (N, n, m), ``f_local`` (N,), ``S_star``/``S_bar``/``mask`` (n, m),
    ``f_star`` 0-dim, ``Q`` (n, n), ``G`` (m, m), ``r_all`` (K, N, 3)
    pre-drawn step uniforms. Returns ``(S_final, S_star, f_star,
    f_trace (K,), f_last (N,))``; ``f_last`` is ``f_local`` when K = 0."""
    bk = kernel_backend.for_config(cfg)
    S, V, S_local = S.float(), V.float(), S_local.float()
    f_local = f_local.float()
    S_star, f_star = S_star.float(), f_star.float()
    f_last, trace = f_local, []
    for r in r_all:
        S, V = bk.pso_update(S, V, S_local, S_star, S_bar, mask, r,
                             omega=cfg.omega, c1=cfg.c1, c2=cfg.c2,
                             c3=cfg.c3, v_max=cfg.v_max)
        S = pso._maybe_requantize(S, mask, cfg)
        f = pso._fitness(S, Q, G, cfg)
        improved = f > f_local
        S_local = torch.where(improved[:, None, None], S, S_local)
        f_local = torch.maximum(f, f_local)
        b = f_local.argmax().reshape(1)
        f_best = f_local.index_select(0, b)[0]
        better = f_best > f_star
        S_star = torch.where(better, S_local.index_select(0, b)[0], S_star)
        f_star = torch.where(better, f_best, f_star)
        trace.append(f_star)
        f_last = f
    f_trace = (torch.stack(trace) if trace else
               torch.zeros(0, dtype=torch.float32, device=S.device))
    return S, S_star, f_star, f_trace, f_last


def split_tail(S, mask, Q, G, cfg: pso.PSOConfig):
    """The loose epilogue of a final swarm S (N, n, m): structured
    projection, feasibility, greedy projection, candidate refinement,
    feasibility, a fitness recompute and the elite consensus. Returns
    ``(M_hat uint8 (N, n, m), feasible bool (N,), S_bar f32 (n, m))``."""
    bk = kernel_backend.for_config(cfg)
    M_a = bk.structured_project(S, Q, G, mask)
    feas_a = bk.is_feasible(M_a, Q, G)
    M_proj = bk.greedy_project(S, mask)
    M_b, _ = pso.ullmann_refine_candidates(S, M_proj, Q, G, mask, cfg)
    feas_b = bk.is_feasible(M_b, Q, G)
    M_hat = torch.where(feas_a[:, None, None], M_a, M_b)
    f_final = pso._fitness(S, Q, G, cfg)
    S_bar, _, _ = pso.elite_consensus(S, f_final, cfg)
    return M_hat.to(torch.uint8), feas_a | feas_b, S_bar


def split_epoch(S, V, S_local, f_local, S_star, f_star, S_bar, mask, Q, G,
                r_all, cfg: pso.PSOConfig):
    """``loose_epoch`` then ``split_tail`` on its final swarm. Returns
    ``(S_final, S_star, f_star, f_trace, f_last, M_hat, feasible,
    S_bar)``."""
    S, S_star, f_star, f_trace, f_last = loose_epoch(
        S, V, S_local, f_local, S_star, f_star, S_bar, mask, Q, G, r_all,
        cfg)
    return (S, S_star, f_star, f_trace, f_last,
            *split_tail(S, mask, Q, G, cfg))
