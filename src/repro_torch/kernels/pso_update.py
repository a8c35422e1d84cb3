"""One PSO step (velocity, clip, position, mask, row normalisation),
batched over particles.

Replaces the TPU kernel ``pso_update_pallas`` of the JAX package
(``kernels/pso_update.py``, body ``_pso_update_kernel``). The CUDA kernel
is ``csrc/pso_update.cu``: one warp per (particle, row), bound on the
H100 by bytes; past m = 256 columns a wide instantiation loops over the
row. It normalises rows by IEEE division where the TPU kernel
multiplied by a reciprocal, so it equals ``ref.pso_update`` (and the
epoch kernel's own step, the same arithmetic in the same order) bit for
bit; against the TPU kernel it stays within the JAX tests' tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as kb

launches = kb.LaunchCounter("pso_update")

_ARGS = [kb.P_] * 9 + [kb.I_] * 4 + [kb.F_] * 5 + [kb.P_]


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous float32, copied only when it is not."""
    if x.dtype is torch.float32 and x.is_contiguous():
        return x
    return x.to(torch.float32).contiguous()


def pso_update_cuda(S, V, S_local, S_star, S_bar, mask, r, *, omega: float,
                    c1: float, c2: float, c3: float, v_max: float = 1.0):
    """Launch the kernel: ``S``/``V``/``S_local`` (…, n, m), ``S_star``/
    ``S_bar``/``mask`` (n, m) shared by every particle, ``r`` (…, 3).
    Returns ``(S_new, V_new)`` float32 (…, n, m), as ``ref.pso_update``."""
    kb.require(S.is_cuda, "pso_update_cuda needs CUDA tensors")
    shape = S.shape
    n, m = shape[-2:]
    if not (V.shape == shape and S_local.shape == shape
            and r.shape == shape[:-2] + (3,)
            and S_star.shape == S_bar.shape == mask.shape == (n, m)):
        raise ValueError(
            f"pso_update_cuda: S, V, S_local {tuple(shape)}, "
            f"r {(*shape[:-2], 3)}, S_star, S_bar, mask {(n, m)}; got V "
            f"{tuple(V.shape)}, S_local {tuple(S_local.shape)}, r "
            f"{tuple(r.shape)}, S_star {tuple(S_star.shape)}, S_bar "
            f"{tuple(S_bar.shape)}, mask {tuple(mask.shape)}")
    mk, mask_i32 = kb.mask_arg(mask)
    Sc = _f32(S)
    S_new, V_new = torch.empty_like(Sc), torch.empty_like(Sc)  # contiguous
    if S_new.numel() == 0:
        return S_new, V_new
    # held until the launch is queued: a copy freed earlier could be
    # handed to the next copy before the kernel reads it
    ins = (Sc, _f32(V), _f32(S_local), _f32(S_star), _f32(S_bar), mk,
           _f32(r), S_new, V_new)
    err = kb.bind("pso_update", "pso_update", _ARGS)(
        *[t.data_ptr() for t in ins], S_new.numel() // (n * m), n, m,
        mask_i32, float(omega), float(c1), float(c2), float(c3),
        float(v_max), kb.stream())
    kb.check(err, "pso_update")
    launches.add()
    return S_new, V_new
