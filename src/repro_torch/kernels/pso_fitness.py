"""Edge-preserving PSO fitness -||Q - S G Sᵀ||², per particle, batched
over problems with their own Q and G.

Replaces the TPU kernels ``edge_fitness_pallas`` and
``edge_fitness_quantized_pallas`` of the JAX package
(``kernels/pso_fitness.py``). The CUDA kernel is ``csrc/pso_fitness.cu``,
one template for both bodies: one CTA per (problem, particle), bound on
the H100 by its fp32 (or int32) operations on CUDA cores. The float body
sums in the plain version's order and the quantized body sums exactly in
int64, so both match the plain versions bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as kb
from repro_torch.kernels import ref

launches = kb.LaunchCounter("edge_fitness")
launches_quantized = kb.LaunchCounter("edge_fitness_quantized")


def edge_fitness_reference(S, Q, G):
    """Plain float version: S (P, N, n, m), Q (P, n, n), G (P, m, m)."""
    ref.strict_fp32(S)
    return ref.edge_fitness(S, Q[:, None], G[:, None])


def edge_fitness_quantized_reference(S_q, Q, G, scale: int = 255):
    """Plain fixed-point version: uint8 S_q (P, N, n, m) → (P, N) f32."""
    return ref.edge_fitness_quantized(S_q, Q[:, None], G[:, None], scale)


def edge_fitness_cuda(S: torch.Tensor, Q: torch.Tensor, G: torch.Tensor,
                      quantized: bool = False,
                      scale: int = 255) -> torch.Tensor:
    """Launch the kernel: float32 S (or uint8 S_q when ``quantized``)
    of shape (P, N, n, m), Q (P, n, n), G (P, m, m) → (P, N) float32."""
    P, N, n, m = S.shape
    kb.require(S.is_cuda, "edge_fitness_cuda needs CUDA tensors")
    kb.require(n <= 256 and m <= 256, f"(n, m) = {(n, m)} exceeds 256")
    kb.require(Q.shape == (P, n, n) and G.shape == (P, m, m),
               "Q/G must be (P, n, n) / (P, m, m)")
    want = torch.uint8 if quantized else torch.float32
    kb.require(S.dtype == want, f"S must be {want}, got {S.dtype}")
    S = S.contiguous()
    Qc = Q.to(torch.uint8).contiguous()
    Gc = G.to(torch.uint8).contiguous()
    out = torch.empty(P, N, dtype=torch.float32, device=S.device)
    if quantized:
        fn = kb.bind("pso_fitness", "edge_fitness_u8",
                     [kb.P_] * 4 + [kb.I_] * 5 + [kb.P_])
        err = fn(kb.ptr(S), kb.ptr(Qc), kb.ptr(Gc), kb.ptr(out), P, N, n, m,
                 int(scale), kb.stream())
    else:
        fn = kb.bind("pso_fitness", "edge_fitness_f32",
                     [kb.P_] * 4 + [kb.I_] * 4 + [kb.P_])
        err = fn(kb.ptr(S), kb.ptr(Qc), kb.ptr(Gc), kb.ptr(out), P, N, n, m,
                 kb.stream())
    kb.check(err, "edge_fitness")
    (launches_quantized if quantized else launches).add()
    return out
