"""Edge-preserving PSO fitness -||Q - S G Sᵀ||², per particle, batched
over problems with their own Q and G.

Replaces the TPU kernels ``edge_fitness_pallas`` and
``edge_fitness_quantized_pallas`` of the JAX package
(``kernels/pso_fitness.py``). The CUDA kernels are
``csrc/pso_fitness.cu`` (float) and ``csrc/fitness_quantized.cu``, bound
on the H100 by their operations on CUDA cores. Each body is two
launches: G's columns packed once per problem (``csrc/fitness.cuh``),
then one CTA per (problem, particle). The float body sums in the plain
version's order, its tiles in shared memory or, past a block's limit
(chosen by the shape), in device scratch; the quantized body holds S as
bytes and runs S G Sᵀ on integer dot products, summing exactly in 64
bits. Past n, m = 256 the float body reads G's columns from the scratch
in place and the quantized one holds S G in 32 bits and S G Sᵀ in 64.
Both match the plain versions bit for bit.
"""
from __future__ import annotations

import ctypes

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
    kb.require(Q.shape == (P, n, n) and G.shape == (P, m, m),
               "Q/G must be (P, n, n) / (P, m, m)")
    want = torch.uint8 if quantized else torch.float32
    kb.require(S.dtype == want, f"S must be {want}, got {S.dtype}")
    S = S.contiguous()
    Qc = Q.to(torch.uint8).contiguous()
    Gc = G.to(torch.uint8).contiguous()
    out = torch.empty(P, N, dtype=torch.float32, device=S.device)
    if quantized:
        nbytes = kb.bind("fitness_quantized", "edge_fitness_u8_scratch_bytes",
                         [kb.I_] * 4, ctypes.c_longlong)(P, N, n, m)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=S.device)
        fn = kb.bind("fitness_quantized", "edge_fitness_u8",
                     [kb.P_] * 5 + [kb.I_] * 5 + [kb.P_])
        err = fn(kb.ptr(S), kb.ptr(Qc), kb.ptr(Gc), kb.ptr(out),
                 kb.ptr(scratch), P, N, n, m, int(scale), kb.stream())
    else:
        # G's column bits, and the tiles where they pass a block's shared
        # memory: the C side sizes both from the shape
        nbytes = kb.bind("pso_fitness", "edge_fitness_f32_scratch_bytes",
                         [kb.I_] * 4, ctypes.c_longlong)(P, N, n, m)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=S.device)
        fn = kb.bind("pso_fitness", "edge_fitness_f32",
                     [kb.P_] * 5 + [kb.I_] * 4 + [kb.P_])
        err = fn(kb.ptr(S), kb.ptr(Qc), kb.ptr(Gc), kb.ptr(out),
                 kb.ptr(scratch), P, N, n, m, kb.stream())
    kb.check(err, "edge_fitness")
    (launches_quantized if quantized else launches).add(2)
    return out
