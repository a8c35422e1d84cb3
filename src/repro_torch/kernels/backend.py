"""Kernel-backend layer: one seam between the matcher and its kernels.

Port of the JAX package's ``kernels/backend.py``. Two suites:

  * ``ref``  — the plain PyTorch versions on any device (``chip_smoke.py``
    holds the kernels against it on the card);
  * ``cuda`` — the dispatch layer (``kernels/ops.py``): hand-written CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors.

``auto`` resolves to ``cuda``. Selection precedence: an explicit name,
then ``PSOConfig.backend`` when it is not ``"auto"``.

Kernels without a TPU kernel behind them (structured projection,
feasibility, injectivity, the quantisation helpers, the elite consensus)
are torch ops on every device, as they are jnp ops in the JAX package.
Per-problem kernels take one problem unless suffixed ``_batch``; the
fitness entries take (B, n, m) with shared Q/G, or (P, N, n, m) with
per-problem Q (P, n, n) and G (P, m, m).
"""
from __future__ import annotations

import types
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.epoch_fused import epoch_inner_reference
from repro_torch.kernels.finish_fused import (elite_consensus_reference,
                                              epoch_finish_reference)
from repro_torch.kernels.prune_fixpoint import prune_fixpoint_reference
from repro_torch.kernels.pso_fitness import (
    edge_fitness_quantized_reference, edge_fitness_reference)

#: Canonical kernel entry points, the same 18 as the JAX package's.
KERNEL_NAMES: Tuple[str, ...] = (
    "edge_fitness",
    "edge_fitness_quantized",
    "pso_update",
    "ullmann_refine_step",
    "greedy_project",
    "masked_argmax",
    "structured_project",
    "injectivity_prune",
    "is_feasible",
    "prune_fixpoint",
    "prune_fixpoint_batch",
    "epoch_fused",
    "epoch_fused_batch",
    "epoch_finish",
    "epoch_finish_batch",
    "quantize_s",
    "dequantize_s",
    "row_normalize_quantized",
)

#: The plain versions under the dispatch layer's names.
_PLAIN = types.SimpleNamespace(
    edge_fitness=edge_fitness_reference,
    edge_fitness_quantized=edge_fitness_quantized_reference,
    prune_fixpoint=prune_fixpoint_reference,
    epoch_fused=epoch_inner_reference,
    epoch_finish=epoch_finish_reference,
    pso_update=ref.pso_update,
    ullmann_refine_step=ref.ullmann_refine_step,
    greedy_project=ref.greedy_project,
    masked_argmax=ref.masked_argmax,
)


class KernelBackend:
    """One kernel suite: every matcher kernel behind a uniform surface."""

    def __init__(self, name: str):
        self.name = name.strip().lower()
        self._ops = ops if self.name == "cuda" else _PLAIN

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"KernelBackend({self.name!r})"

    # -- fitness -----------------------------------------------------------

    def edge_fitness(self, S, Q, G):
        """-||Q - S G Sᵀ||²: S (B, n, m) → (B,), or (P, N, n, m) → (P, N)."""
        if S.dim() == 3:
            return self._ops.edge_fitness(S[None], Q[None], G[None])[0]
        return self._ops.edge_fitness(S, Q, G)

    def edge_fitness_quantized(self, S_q, Q, G, scale: int = 255):
        """Fixed-point fitness (uint8 S, integer MACs) → float32."""
        if S_q.dim() == 3:
            return self._ops.edge_fitness_quantized(
                S_q[None], Q[None], G[None], scale)[0]
        return self._ops.edge_fitness_quantized(S_q, Q, G, scale)

    # -- swarm update ------------------------------------------------------

    def pso_update(self, S, V, S_local, S_star, S_bar, mask, r, *,
                   omega, c1, c2, c3, v_max=1.0):
        """One PSO step, batched over particles."""
        return self._ops.pso_update(S, V, S_local, S_star, S_bar, mask, r,
                                    omega=omega, c1=c1, c2=c2, c3=c3,
                                    v_max=v_max)

    # -- refinement / pruning ----------------------------------------------

    def ullmann_refine_step(self, M, Q, G):
        """One refinement sweep, batched. M: (B, n, m) → (B, n, m)."""
        return self._ops.ullmann_refine_step(M, Q, G)

    def injectivity_prune(self, M):
        """All-different propagation on a candidate matrix."""
        return ref.injectivity_prune(M)

    def prune_fixpoint(self, mask, Q, G, max_iters: int = 0):
        """Fused pre-prune of ONE (n, m) mask → (pruned, sweeps)."""
        out, sweeps = self.prune_fixpoint_batch(mask[None], Q[None], G[None],
                                                max_iters=max_iters)
        return out[0], sweeps[0]

    def prune_fixpoint_batch(self, maskb, Qb, Gb, max_iters: int = 0):
        """Fused pre-prune, batched over problems with their own Q/G."""
        return self._ops.prune_fixpoint(maskb, Qb, Gb, max_iters)

    # -- fused epoch loop --------------------------------------------------

    def epoch_fused(self, S, V, S_local, f_local, S_star, f_star, S_bar,
                    mask, Q, G, r_all, *, omega, c1, c2, c3, v_max,
                    quantized: bool = False):
        """The K-step epoch loop for ONE problem → (S_final, S_star,
        f_star, f_trace (K,), f_last (N,))."""
        outs = self.epoch_fused_batch(
            S[None], V[None], S_local[None], f_local[None], S_star[None],
            f_star.reshape(1), S_bar[None], mask[None], Q[None], G[None],
            r_all[None], omega=omega, c1=c1, c2=c2, c3=c3, v_max=v_max,
            quantized=quantized)
        return tuple(x[0] for x in outs)

    def epoch_fused_batch(self, S, V, S_local, f_local, S_star, f_star,
                          S_bar, mask, Q, G, r_all, *, omega, c1, c2, c3,
                          v_max, quantized: bool = False):
        """The epoch loop over a leading problem axis P."""
        return self._ops.epoch_fused(S, V, S_local, f_local, S_star, f_star,
                                     S_bar, mask, Q, G, r_all, omega=omega,
                                     c1=c1, c2=c2, c3=c3, v_max=v_max,
                                     quantized=quantized)

    # -- fused epoch tail --------------------------------------------------

    def epoch_finish(self, S, f_final, gum, mask, Q, G, *, gumbel_tau,
                     refine_threshold, refine_iters, elite_k,
                     consensus_temp):
        """The epoch tail for ONE problem → (M_hat, feasible, S_bar)."""
        outs = self.epoch_finish_batch(
            S[None], f_final[None], None if gum is None else gum[None],
            mask[None], Q[None], G[None], gumbel_tau=gumbel_tau,
            refine_threshold=refine_threshold, refine_iters=refine_iters,
            elite_k=elite_k, consensus_temp=consensus_temp)
        return tuple(x[0] for x in outs)

    def epoch_finish_batch(self, S, f_final, gum, mask, Q, G, *,
                           gumbel_tau, refine_threshold, refine_iters,
                           elite_k, consensus_temp):
        """The epoch tail over a leading problem axis P."""
        return self._ops.epoch_finish(S, f_final, gum, mask, Q, G,
                                      gumbel_tau=gumbel_tau,
                                      refine_threshold=refine_threshold,
                                      refine_iters=refine_iters,
                                      elite_k=elite_k,
                                      consensus_temp=consensus_temp)

    def ullmann_refine_candidates(self, S, M_proj, Q, G, mask, *,
                                  refine_threshold, refine_iters):
        """Candidate refinement for ONE problem, batched over particles,
        composed from this suite's own sweep (so on the ``cuda`` suite it
        raises on CUDA tensors until ``ullmann_refine_step`` is ported).
        Returns ``(M_hat uint8, cand uint8)``."""
        rowmax = S.amax(-1, keepdim=True)
        cand = ((S >= refine_threshold * rowmax) | (M_proj > 0))
        cand = (cand & (mask[None] > 0)).to(torch.uint8)
        for _ in range(refine_iters):
            cand = self.ullmann_refine_step(cand, Q, G)
        S_restricted = S * cand.to(S.dtype)
        M_hat = self.structured_project(S_restricted, Q, G, cand)
        empty_rows = cand.sum(-1, keepdim=True) == 0
        M_hat = torch.where(empty_rows, M_proj, M_hat)
        return M_hat.to(torch.uint8), cand

    def elite_consensus(self, S_all, f_all, *, elite_k, consensus_temp):
        """S̄ parts ``(weighted, weight_total, w)`` of the elite_k best."""
        return elite_consensus_reference(S_all, f_all, elite_k=elite_k,
                                         consensus_temp=consensus_temp)

    # -- projection / verification -----------------------------------------

    def greedy_project(self, S, mask):
        """Greedy argmax projection of one relaxed (n, m) S → uint8 M̂."""
        return self._ops.greedy_project(S, mask)

    def masked_argmax(self, X, mask):
        """Masked global argmax → (value, flat index)."""
        return self._ops.masked_argmax(X, mask)

    def structured_project(self, S, Q, G, mask):
        """Adjacency-guided constructive projection (batched torch ops)."""
        return ref.structured_project(S, Q, G, mask)

    def is_feasible(self, M, Q, G):
        """Injective-assignment + edge-cover feasibility."""
        return ref.is_feasible(M, Q, G)

    # -- quantization helpers ----------------------------------------------

    def quantize_s(self, S, scale: int = 255):
        return ref.quantize_s(S, scale)

    def dequantize_s(self, S_q, scale: int = 255):
        return ref.dequantize_s(S_q, scale)

    def row_normalize_quantized(self, S_q, mask, scale: int = 255):
        return ref.row_normalize_quantized(S_q, mask, scale)


_REGISTRY: Dict[str, KernelBackend] = {
    name: KernelBackend(name) for name in ("ref", "cuda")}


def registered_backends() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_backend_name(name: Optional[str] = None, config=None) -> str:
    """Explicit name, then ``config.backend`` unless ``"auto"``, then
    ``cuda``."""
    for cand in (name, getattr(config, "backend", None)):
        if cand and str(cand).strip().lower() != "auto":
            return str(cand).strip().lower()
    return "cuda"


def get_backend(name: Optional[str] = None, *, config=None) -> KernelBackend:
    resolved = resolve_backend_name(name, config)
    try:
        return _REGISTRY[resolved]
    except KeyError:
        raise KeyError(f"unknown kernel backend {resolved!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def for_config(cfg) -> KernelBackend:
    """The backend a ``PSOConfig`` selects."""
    return get_backend(config=cfg)
