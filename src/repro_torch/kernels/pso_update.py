"""One PSO step (velocity, clip, position, mask, row normalisation),
batched over particles.

Replaces the TPU kernel ``pso_update_pallas`` of the JAX package
(``kernels/pso_update.py``, body ``_pso_update_kernel``). The CUDA kernel
is ``csrc/pso_update.cu``: one CTA per particle, bound on the H100 by
bytes. It normalises rows by IEEE division where the TPU kernel
multiplied by a reciprocal, so it equals ``ref.pso_update`` (and the
epoch kernel's own step, the same arithmetic in the same order) bit for
bit; against the TPU kernel it stays within the JAX tests' tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as kb

launches = kb.LaunchCounter("pso_update")


def pso_update_cuda(S, V, S_local, S_star, S_bar, mask, r, *, omega: float,
                    c1: float, c2: float, c3: float, v_max: float = 1.0):
    """Launch the kernel: ``S``/``V``/``S_local`` (…, n, m), ``S_star``/
    ``S_bar``/``mask`` (n, m) shared by every particle, ``r`` (…, 3).
    Returns ``(S_new, V_new)`` float32 (…, n, m), as ``ref.pso_update``."""
    kb.require(S.is_cuda, "pso_update_cuda needs CUDA tensors")
    n, m = S.shape[-2:]
    lead = tuple(S.shape[:-2])
    kb.require(n <= 256 and m <= 256, f"(n, m) = {(n, m)} exceeds 256")
    kb.require(V.shape == S.shape and S_local.shape == S.shape,
               "S, V and S_local must have one shape")
    kb.require(tuple(r.shape) == lead + (3,), f"r must be {lead + (3,)}")
    kb.require(S_star.shape == S_bar.shape == mask.shape == (n, m),
               "S_star, S_bar and mask must be (n, m)")
    f32 = lambda x: x.to(torch.float32).contiguous()
    Sc, Vc, Lc, star, bar, rc = (f32(x) for x in (S, V, S_local, S_star,
                                                  S_bar, r))
    mk, mask_i32 = kb.mask_arg(mask)
    S_new = torch.empty(lead + (n, m), dtype=torch.float32, device=S.device)
    V_new = torch.empty_like(S_new)
    if S_new.numel() == 0:
        return S_new, V_new
    fn = kb.bind("pso_update", "pso_update",
                 [kb.P_] * 9 + [kb.I_] * 4 + [kb.F_] * 5 + [kb.P_])
    err = fn(*[kb.ptr(t) for t in (Sc, Vc, Lc, star, bar, mk, rc, S_new,
                                   V_new)],
             S_new.numel() // (n * m), n, m, mask_i32, float(omega),
             float(c1), float(c2), float(c3), float(v_max), kb.stream())
    kb.check(err, "pso_update")
    launches.add()
    return S_new, V_new
