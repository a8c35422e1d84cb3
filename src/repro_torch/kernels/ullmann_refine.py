"""One Ullmann refinement sweep, batched over candidate matrices.

Replaces the TPU kernel ``ullmann_refine_step_pallas`` of the JAX package
(``kernels/ullmann_refine.py``, body ``_refine_kernel``). The CUDA kernel
is ``csrc/ullmann_refine.cu``: one CTA per candidate matrix stages G and Q
with 16-byte loads and packs them lane-transposed in shared memory, and
the sweep builds each row's supports as unions of G's packed rows over
the row's candidates, so the four 0/1 products become byte ORs and ANDs.
Past n, m = 256 a wide instantiation packs Q and G once into device
scratch, which this wrapper allocates, and keeps a matrix's bit planes
in shared memory or, where they pass it, in device scratch too. Its
output is exact and equals ``ref.ullmann_refine_step`` bit for bit, in
M's dtype (uint8, int32 or bool; Q and G uint8, int32 or bool).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as kb

launches = kb.LaunchCounter("ullmann_refine_step")


def ullmann_refine_step_cuda(M: torch.Tensor, Q: torch.Tensor,
                             G: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``M`` (…, n, m) non-negative candidates, ``Q``
    (n, n) and ``G`` (m, m) shared by every matrix. Returns the swept M,
    same shape and dtype."""
    kb.require(M.is_cuda, "ullmann_refine_step_cuda needs CUDA tensors")
    n, m = M.shape[-2:]
    kb.require(M.dtype in (torch.uint8, torch.int32, torch.bool),
               f"M dtype {M.dtype} not supported")
    kb.require(Q.shape == (n, n) and G.shape == (m, m),
               "Q/G must be (n, n) / (m, m)")
    Mc, m_i32 = kb.mask_arg(M)
    Qc, q_i32 = kb.mask_arg(Q)
    Gc, g_i32 = kb.mask_arg(G)
    out = torch.empty_like(Mc)
    if out.numel() == 0:
        return out.view(M.dtype)
    B = out.numel() // (n * m)
    nbytes = kb.bind("ullmann_refine", "ullmann_refine_scratch_bytes",
                     [kb.I_] * 3, ctypes.c_longlong)(B, n, m)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=M.device)
               if nbytes else None)
    fn = kb.bind("ullmann_refine", "ullmann_refine_step",
                 [kb.P_] * 5 + [kb.I_] * 6 + [kb.P_])
    err = fn(kb.ptr(Mc), kb.ptr(Qc), kb.ptr(Gc), kb.ptr(out),
             None if scratch is None else kb.ptr(scratch), B, n, m, m_i32,
             q_i32, g_i32, kb.stream())
    kb.check(err, "ullmann_refine_step")
    launches.add(2 if nbytes else 1)   # the wide path packs Q and G first
    return out.view(M.dtype)
