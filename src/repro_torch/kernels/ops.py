"""Dispatch layer: a CPU tensor goes to the plain version, a CUDA tensor
to the hand-written kernel.

Port of the JAX package's ``kernels/ops.py``. All nine kernels take any
n, m that the card's memory holds (``masked_argmax`` any n·m up to
2**31 - 1024, its flat index being int32): the five of the main path
(the fitness bodies, the pre-prune, the fused epoch and its tail) and
the split epoch's four (``pso_update``, ``ullmann_refine_step``,
``greedy_project``, ``masked_argmax``), through an instantiation for
n, m <= 256 and a wide one past it (``masked_argmax``'s one scan takes
every size), so the 128-row MXU padding of the TPU path is gone. There
is no fallback: on a CUDA tensor a function launches its kernel or
raises. Q and G are 0/1 adjacency matrices, as
``core.graphs.as_device_graphs`` checks: several kernels (the fused
epoch among them) read them as bits, so on other values a kernel need
not agree with its plain version.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.argmax_project import (greedy_project_cuda,
                                                masked_argmax_cuda)
from repro_torch.kernels.epoch_fused import (epoch_fused_cuda,
                                             epoch_inner_reference)
from repro_torch.kernels.finish_fused import (epoch_finish_cuda,
                                              epoch_finish_reference)
from repro_torch.kernels.prune_fixpoint import (prune_fixpoint_cuda,
                                                prune_fixpoint_reference)
from repro_torch.kernels.pso_fitness import (
    edge_fitness_cuda, edge_fitness_quantized_reference,
    edge_fitness_reference)
from repro_torch.kernels.pso_update import pso_update_cuda
from repro_torch.kernels.ullmann_refine import ullmann_refine_step_cuda


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


def pso_update(S, V, S_local, S_star, S_bar, mask, r, *, omega, c1, c2,
               c3, v_max=1.0):
    """One PSO step: S/V/S_local (…, n, m), shared S*/S̄/mask, r (…, 3)
    → (S_new, V_new)."""
    kw = dict(omega=omega, c1=c1, c2=c2, c3=c3, v_max=v_max)
    if S.is_cuda:
        return pso_update_cuda(S, V, S_local, S_star, S_bar, mask, r, **kw)
    return ref.pso_update(S, V, S_local, S_star, S_bar, mask, r, **kw)


def ullmann_refine_step(M, Q, G):
    """One Ullmann sweep of M (…, n, m) against shared Q/G."""
    if M.is_cuda:
        return ullmann_refine_step_cuda(M, Q, G)
    return ref.ullmann_refine_step(M, Q, G)


def greedy_project(S, mask):
    """Greedy argmax projection of S (…, n, m) → uint8 M̂."""
    if S.is_cuda:
        return greedy_project_cuda(S, mask)
    return ref.greedy_project(S, mask)


def masked_argmax(X, mask):
    """Masked global argmax of one (n, m) X → (value, i·m + j)."""
    if X.is_cuda:
        return masked_argmax_cuda(X, mask)
    return ref.masked_argmax(X, mask)
