"""Edge-preserving PSO fitness -||Q - S G Sᵀ||², per particle, batched
over problems with their own Q and G.

Replaces the TPU kernels ``edge_fitness_pallas`` and
``edge_fitness_quantized_pallas`` of the JAX package
(``kernels/pso_fitness.py``). The CUDA kernels are
``csrc/pso_fitness.cu`` (float) and ``csrc/fitness_quantized.cu``, bound
on the H100 by their operations on CUDA cores. Each body is two
launches: G's columns packed once per problem (``csrc/fitness.cuh``),
then the body. Up to n, m = 256 the body runs one CTA per (problem,
particle): the float body sums in the plain version's order, its tiles
in shared memory or, past a block's limit (chosen by the shape), in
device scratch; the quantized body holds S as bytes and runs S G Sᵀ on
integer dot products, summing exactly in 64 bits. Past 256 each splits a
particle's rows over several CTAs (``path``): the float body keeps the
plain order with its row sums added by the particle's last CTA, the
quantized one runs S G Sᵀ on the u8 tensor cores over byte planes of
S G and adds the CTAs' 64-bit sums; where the split does not fit in
shared memory, one CTA a particle as up to 256. Both match the plain
versions bit for bit.
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


def path(P: int, N: int, n: int, m: int, quantized: bool) -> int:
    """The body the card runs for P problems of N particles at (n, m): 0
    up to n, m = 256, past it the rows a CTA of the row-split kernel
    (``fitness_rows_kernel`` / ``fitness_u8_rows_kernel``), or -1 for one
    CTA a particle (``fitness_wide_kernel<*>`` /
    ``fitness_u8_wide_kernel``)."""
    if quantized:
        return kb.bind("fitness_quantized", "edge_fitness_u8_path",
                       [kb.I_] * 4)(P, N, n, m)
    return kb.bind("pso_fitness", "edge_fitness_f32_path",
                   [kb.I_] * 4)(P, N, n, m)


def instantiation(P: int, N: int, n: int, m: int, quantized: bool) -> str:
    """``path`` as the name of the kernel and its rows a CTA."""
    r = path(P, N, n, m, quantized)
    if r > 0:
        return (f"fitness_u8_rows_kernel<{r // 16}>, {r} rows a CTA"
                if quantized else f"fitness_rows_kernel, {r} rows a CTA")
    if r == 0:
        return "fitness_u8_kernel" if quantized else "fitness_kernel<*>"
    return "fitness_u8_wide_kernel" if quantized else "fitness_wide_kernel<*>"


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
