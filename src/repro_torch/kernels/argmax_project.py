"""Greedy argmax projection and the masked global argmax.

Replaces the TPU kernels ``greedy_project_pallas`` and
``masked_argmax_pallas`` of the JAX package (``kernels/argmax_project.py``,
bodies ``_project_kernel`` and ``_masked_argmax_kernel``). The CUDA
source is ``csrc/argmax_project.cu``:

  * ``greedy_project``: one CTA per leading index, warp 0 running the
    cached argmax chain of the fused epoch tail (``rt::greedy_warp``,
    up to n dependent rounds), bound on the H100 by the latency of that
    chain;
  * ``masked_argmax``: one CTA over the (n, m) entries.

Past n, m = 256 ``greedy_project`` takes a wide instantiation (the
chain on 32-bit words a lane) that packs the mask once into device
scratch, which this wrapper allocates; ``masked_argmax``'s scan takes
any n·m up to 2**31 - 1024 (its flat index is int32). Both are exact:
ties go to the smallest flat index i·m + j as in ``torch.argmax``, so
they equal ``ref.greedy_project`` and ``ref.masked_argmax`` bit for bit
(finite inputs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as kb

launches_greedy = kb.LaunchCounter("greedy_project")
launches_argmax = kb.LaunchCounter("masked_argmax")


_GREEDY_ARGS = [kb.P_] * 4 + [kb.I_] * 4 + [kb.P_]
#: the largest n·m of ``masked_argmax``: its flat index is int32, and a
#: thread's index must not wrap when it steps past the last entry
MAX_FLAT = 2**31 - 1024


def greedy_project_cuda(S: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``S`` (…, n, m), ``mask`` (n, m) shared by
    every matrix. Returns uint8 M̂ (…, n, m). S is copied only when it is
    not contiguous float32."""
    kb.require(S.is_cuda, "greedy_project_cuda needs CUDA tensors")
    n, m = S.shape[-2:]
    if mask.shape != (n, m):
        raise ValueError(f"greedy_project_cuda: mask {tuple(mask.shape)} "
                         f"must be (n, m) = {(n, m)}")
    if S.dtype is not torch.float32 or not S.is_contiguous():
        S = S.to(torch.float32).contiguous()
    mk, mask_i32 = kb.mask_arg(mask)
    out = torch.empty(S.shape, dtype=torch.uint8, device=S.device)
    if out.numel() == 0:
        return out
    nbytes = kb.bind("argmax_project", "greedy_project_scratch_bytes",
                     [kb.I_] * 2, ctypes.c_longlong)(n, m)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=S.device)
               if nbytes else None)
    err = kb.bind("argmax_project", "greedy_project", _GREEDY_ARGS)(
        S.data_ptr(), mk.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        out.numel() // (n * m), n, m, mask_i32, kb.stream())
    kb.check(err, "greedy_project")
    launches_greedy.add(2 if nbytes else 1)   # the wide path packs first
    return out


_ARGMAX_ARGS = [kb.P_] * 4 + [kb.I_] * 2 + [kb.P_]


def masked_argmax_cuda(X: torch.Tensor, mask: torch.Tensor):
    """Launch the kernel: ``X`` (n, m), ``mask`` (n, m). Returns 0-dim
    ``(value float32, flat index int32)`` on the device, views of one
    two-word buffer. X is copied only when it is not contiguous
    float32; the mask goes through ``kb.mask_arg``."""
    kb.require(X.is_cuda and mask.is_cuda,
               "masked_argmax_cuda needs CUDA tensors")
    kb.require(X.dim() == 2 and mask.shape == X.shape,
               "X and mask must be one (n, m) shape")
    n, m = X.shape
    kb.require(n > 0 and m > 0 and n * m <= MAX_FLAT,
               f"(n, m) = {(n, m)}: n, m >= 1 and n·m <= {MAX_FLAT}")
    if X.dtype != torch.float32 or not X.is_contiguous():
        X = X.to(torch.float32).contiguous()
    mask, mask_i32 = kb.mask_arg(mask)
    out = torch.empty(2, dtype=torch.int32, device=X.device)
    o = out.data_ptr()
    err = kb.bind("argmax_project", "masked_argmax", _ARGMAX_ARGS)(
        X.data_ptr(), mask.data_ptr(), o, o + 4, n * m, mask_i32,
        kb.stream())
    kb.check(err, "masked_argmax")
    launches_argmax.add()
    val, idx = out.unbind()
    return val.view(torch.float32), idx
