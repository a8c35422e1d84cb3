"""Fused global pre-prune to fixpoint, batched over problems.

Replaces the TPU kernel ``prune_fixpoint_pallas`` of the JAX package
(``kernels/prune_fixpoint.py``, bodies ``_prune_kernel`` and
``_fused_step``). The CUDA kernel is ``csrc/prune_fixpoint.cu``: one CTA
per problem with the mask, Q and G as bit rows in shared memory. On the
H100 it is bound by the latency of its chain of dependent sweeps, not by
bytes or operations; its outputs are exact, so they match the plain
version bit for bit. Mask entries are taken as 0/1 (nonzero = 1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as kb
from repro_torch.kernels import ref

launches = kb.LaunchCounter("prune_fixpoint")


def prune_fixpoint_reference(maskb, Qb, Gb, max_iters: int = 0):
    """Plain version: ``ref.prune_fixpoint_count`` on (P, n, m) masks."""
    return ref.prune_fixpoint_count(maskb, Qb, Gb, max_iters)


def prune_fixpoint_cuda(maskb: torch.Tensor, Qb: torch.Tensor,
                        Gb: torch.Tensor, max_iters: int = 0):
    """Launch the kernel. ``maskb`` (P, n, m) uint8 or int32, ``Qb``
    (P, n, n), ``Gb`` (P, m, m) 0/1. Returns ``(pruned mask of maskb's
    dtype, sweeps (P,) int32)``."""
    P, n, m = maskb.shape
    kb.require(maskb.is_cuda, "prune_fixpoint_cuda needs CUDA tensors")
    kb.require(maskb.dtype in (torch.uint8, torch.int32),
               f"mask dtype {maskb.dtype} not supported")
    kb.require(n <= 256 and m <= 256, f"(n, m) = {(n, m)} exceeds 256")
    kb.require(Qb.shape == (P, n, n) and Gb.shape == (P, m, m),
               "Q/G must be (P, n, n) / (P, m, m)")
    mk = maskb.contiguous()
    Q = Qb.to(torch.uint8).contiguous()
    G = Gb.to(torch.uint8).contiguous()
    out = torch.empty_like(mk)
    sweeps = torch.empty(P, dtype=torch.int32, device=mk.device)
    fn = kb.bind("prune_fixpoint",
                 "prune_fixpoint_u8" if mk.dtype == torch.uint8
                 else "prune_fixpoint_i32",
                 [kb.P_] * 5 + [kb.I_] * 4 + [kb.P_])
    err = fn(kb.ptr(mk), kb.ptr(Q), kb.ptr(G), kb.ptr(out), kb.ptr(sweeps),
             P, n, m, int(max_iters or 0), kb.stream())
    kb.check(err, "prune_fixpoint")
    launches.add()
    return out, sweeps
