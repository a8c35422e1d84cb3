"""The fused epoch tail: projections, Ullmann refinement, feasibility and
the elite consensus, batched over problems.

Replaces the TPU kernel ``epoch_finish_pallas`` of the JAX package
(``kernels/finish_fused.py``, bodies ``_finish_kernel``,
``_batched_structured``, ``_batched_greedy``, ``_batched_sweep`` and
``_batched_feasible``). The CUDA source ``csrc/finish_fused.cu`` makes
two launches per call: one CTA per (problem, particle) for the
projections, sweeps and feasibility, then one CTA per problem for the
elite consensus S̄. Both count in ``launches``. The first is bound on the
H100 by the latency of its n-round argmax chains. Integer outputs match
the plain version bit for bit; S̄ agrees to float32 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as kb
from repro_torch.kernels import ref

launches = kb.LaunchCounter("epoch_finish")


def ullmann_refine_candidates_reference(S, M_proj, Q, G, mask, *,
                                        refine_threshold: float,
                                        refine_iters: int):
    """Candidate refinement of paper line 20: threshold ∪ projection
    candidate set, ``refine_iters`` Ullmann sweeps, structured
    re-projection with an empty-row fallback to ``M_proj``. ``S``/
    ``M_proj`` (…, N, n, m); ``Q``/``G``/``mask`` carry the leading dims
    without N. Returns ``(M_hat uint8, cand uint8)``."""
    Qn, Gn, mk = Q.unsqueeze(-3), G.unsqueeze(-3), mask.unsqueeze(-3)
    rowmax = S.amax(-1, keepdim=True)
    cand = (S >= refine_threshold * rowmax) | (M_proj > 0)
    cand = (cand & (mk > 0)).to(torch.uint8)
    for _ in range(refine_iters):
        cand = ref.ullmann_refine_step(cand, Qn, Gn)
    S_restricted = S * cand.to(S.dtype)
    M_hat = ref.structured_project(S_restricted, Qn, Gn, cand)
    empty_rows = cand.sum(-1, keepdim=True) == 0
    M_hat = torch.where(empty_rows, M_proj, M_hat)
    return M_hat.to(torch.uint8), cand


def elite_consensus_reference(S_all, f_all, *, elite_k: int,
                              consensus_temp: float):
    """S̄: softmax-weighted average of the ``elite_k`` fittest particles.

    ``S_all`` (…, N, n, m), ``f_all`` (…, N). The top-k is ``elite_k``
    rounds of argmax with the winner masked to finfo.min, which orders
    ties lower index first like ``jax.lax.top_k``. Returns
    ``(weighted, weight_total, w)``."""
    f_work = f_all.float().clone()
    idx, f_top = [], []
    for _ in range(elite_k):
        b = f_work.argmax(-1, keepdim=True)
        idx.append(b)
        f_top.append(f_work.gather(-1, b))
        f_work = f_work.scatter(-1, b, ref.NEG)
    idx = torch.cat(idx, -1)
    f_top = torch.cat(f_top, -1)
    f_norm = ref.fdiv(f_top - f_top[..., :1], consensus_temp)
    w = torch.softmax(f_norm, -1)
    gidx = idx[..., None, None].expand(*idx.shape, *S_all.shape[-2:])
    S_top = S_all.float().gather(-3, gidx)
    weighted = (w[..., None, None] * S_top).sum(-3)
    return weighted, w.sum(-1), w


def epoch_finish_reference(S, f_final, gum, mask, Q, G, *,
                           gumbel_tau: float, refine_threshold: float,
                           refine_iters: int, elite_k: int,
                           consensus_temp: float):
    """Plain version of the fused epoch tail, batched over problems:
    ``S`` (P, N, n, m), ``f_final`` (P, N), ``gum`` (P, N, n, m) or
    ``None`` (τ = 0), ``mask`` (P, n, m), ``Q`` (P, n, n), ``G``
    (P, m, m). Returns ``(M_hat uint8 (P, N, n, m), feasible bool (P, N),
    S_bar f32 (P, n, m))``."""
    ref.strict_fp32(S)
    S = S.float()
    Qn, Gn, mk = Q[:, None], G[:, None], mask[:, None]
    if gumbel_tau > 0:
        S_proj_a = torch.log(S.clamp(min=1e-9)) + gumbel_tau * gum.float()
    else:
        S_proj_a = S
    M_a = ref.structured_project(S_proj_a, Qn, Gn, mk)
    feas_a = ref.is_feasible(M_a, Qn, Gn)
    M_proj = ref.greedy_project(S, mk)
    M_b, _ = ullmann_refine_candidates_reference(
        S, M_proj, Q, G, mask, refine_threshold=refine_threshold,
        refine_iters=refine_iters)
    feas_b = ref.is_feasible(M_b, Qn, Gn)
    M_hat = torch.where(feas_a[..., None, None], M_a, M_b)
    S_bar, _, _ = elite_consensus_reference(
        S, f_final, elite_k=elite_k, consensus_temp=consensus_temp)
    return M_hat.to(torch.uint8), feas_a | feas_b, S_bar


def epoch_finish_cuda(S, f_final, gum, mask, Q, G, *, gumbel_tau: float,
                      refine_threshold: float, refine_iters: int,
                      elite_k: int, consensus_temp: float):
    """Launch the kernels (same arguments and results as
    ``epoch_finish_reference``)."""
    P, N, n, m = S.shape
    kb.require(S.is_cuda, "epoch_finish_cuda needs CUDA tensors")
    kb.require(n <= 256 and m <= 256, f"(n, m) = {(n, m)} exceeds 256")
    kb.require(1 <= elite_k <= N, f"elite_k {elite_k} not in [1, {N}]")
    Sc = S.to(torch.float32).contiguous()
    fc = f_final.to(torch.float32).contiguous()
    use_gum = gumbel_tau > 0
    if use_gum:
        kb.require(gum is not None and gum.shape == S.shape,
                   "gumbel_tau > 0 needs a (P, N, n, m) gum field")
        gc = gum.to(torch.float32).contiguous()
    mk = (mask != 0).to(torch.uint8).contiguous()
    Qc = Q.to(torch.uint8).contiguous()
    Gc = G.to(torch.uint8).contiguous()
    M_hat = torch.empty(P, N, n, m, dtype=torch.uint8, device=S.device)
    feas = torch.empty(P, N, dtype=torch.bool, device=S.device)
    S_bar = torch.empty(P, n, m, dtype=torch.float32, device=S.device)
    fn = kb.bind("finish_fused", "epoch_finish",
                 [kb.P_] * 9 + [kb.I_] * 4 + [kb.F_, kb.F_, kb.I_, kb.I_,
                                              kb.F_, kb.P_])
    err = fn(kb.ptr(Sc), kb.ptr(fc), kb.ptr(gc) if use_gum else None,
             kb.ptr(mk), kb.ptr(Qc), kb.ptr(Gc), kb.ptr(M_hat), kb.ptr(feas),
             kb.ptr(S_bar), P, N, n, m, float(gumbel_tau),
             float(refine_threshold), int(refine_iters), int(elite_k),
             float(consensus_temp), kb.stream())
    kb.check(err, "epoch_finish")
    launches.add(2)
    return M_hat, feas, S_bar
