"""Dispatch layer: a CPU tensor goes to the plain version, a CUDA tensor
to the hand-written kernel.

Port of the JAX package's ``kernels/ops.py``. The kernels take any
``n, m <= 256``, so the 128-row MXU padding of the TPU path is gone.
There is no fallback: on a CUDA tensor a function launches its kernel or
raises. The four TPU kernels that are not ported yet raise on CUDA
tensors with the ROADMAP row that tracks them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.epoch_fused import (epoch_fused_cuda,
                                             epoch_inner_reference)
from repro_torch.kernels.finish_fused import (epoch_finish_cuda,
                                              epoch_finish_reference)
from repro_torch.kernels.prune_fixpoint import (prune_fixpoint_cuda,
                                                prune_fixpoint_reference)
from repro_torch.kernels.pso_fitness import (
    edge_fitness_cuda, edge_fitness_quantized_reference,
    edge_fitness_reference)

#: TPU kernels without a CUDA port yet → their ROADMAP Queue 2 row.
NOT_PORTED = {
    "pso_update": "ROADMAP Queue 2 item 6 (pso_update_pallas)",
    "ullmann_refine_step": "ROADMAP Queue 2 item 5 "
                           "(ullmann_refine_step_pallas)",
    "greedy_project": "ROADMAP Queue 2 item 7 (greedy_project_pallas)",
    "masked_argmax": "ROADMAP Queue 2 item 8 (masked_argmax_pallas)",
}


def _not_ported(name: str, x: torch.Tensor) -> None:
    if x.is_cuda:
        raise NotImplementedError(
            f"{name} has no CUDA kernel yet: {NOT_PORTED[name]}")


def edge_fitness(S, Q, G):
    """Float fitness: S (P, N, n, m), Q (P, n, n), G (P, m, m) → (P, N)."""
    if S.is_cuda:
        return edge_fitness_cuda(S.float(), Q, G)
    return edge_fitness_reference(S, Q, G)


def edge_fitness_quantized(S_q, Q, G, scale: int = 255):
    """Fixed-point fitness: uint8 S_q (P, N, n, m) → (P, N) float32."""
    if S_q.is_cuda:
        return edge_fitness_cuda(S_q, Q, G, quantized=True, scale=scale)
    return edge_fitness_quantized_reference(S_q, Q, G, scale)


def prune_fixpoint(maskb, Qb, Gb, max_iters: int = 0):
    """Fused pre-prune to fixpoint → (pruned (P, n, m), sweeps (P,))."""
    if maskb.is_cuda:
        return prune_fixpoint_cuda(maskb, Qb, Gb, max_iters)
    return prune_fixpoint_reference(maskb, Qb, Gb, max_iters)


def epoch_fused(*args, **kw):
    """The K-step epoch loop over (P, N, n, m) particle state."""
    if args[0].is_cuda:
        return epoch_fused_cuda(*args, **kw)
    return epoch_inner_reference(*args, **kw)


def epoch_finish(*args, **kw):
    """The epoch tail → (M_hat, feasible, S_bar)."""
    if args[0].is_cuda:
        return epoch_finish_cuda(*args, **kw)
    return epoch_finish_reference(*args, **kw)


def pso_update(S, *args, **kw):
    _not_ported("pso_update", S)
    return ref.pso_update(S, *args, **kw)


def ullmann_refine_step(M, Q, G):
    _not_ported("ullmann_refine_step", M)
    return ref.ullmann_refine_step(M, Q, G)


def greedy_project(S, mask):
    _not_ported("greedy_project", S)
    return ref.greedy_project(S, mask)


def masked_argmax(X, mask):
    _not_ported("masked_argmax", X)
    return ref.masked_argmax(X, mask)
