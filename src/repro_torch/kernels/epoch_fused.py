"""The fused swarm epoch: K inner PSO steps, batched over problems.

Replaces the TPU kernel ``epoch_fused_pallas`` of the JAX package
(``kernels/epoch_fused.py``, body ``_epoch_kernel``). The CUDA kernel is
``csrc/epoch_fused.cu``: the global best S* couples every particle at
every step and a grid of P·N particle CTAs cannot all be resident for a
barrier across them, so one prologue launch builds each problem's
operands in device scratch and each inner step is one launch of a (N, P)
grid (one CTA per particle) whose last CTA per problem picks that
problem's global best: K + 1 launches an epoch (none when K = 0), all
counted. Compiled with ``-fmad=false`` and written in the plain version's
order of operations, it matches ``epoch_inner_reference`` bit for bit.
Q and G are 0/1 adjacency matrices, as everywhere in the matcher. Any
n, m run; where the problem's record passes a block's shared memory the
steps read it from the scratch in place. Past n, m = 256, where a
thread-block cluster of C CTAs (2, 4 or 8) holds a particle's tiles in
its shared memory, a step runs a cluster a particle instead, each CTA a
slice of the rows, the quantized S G Sᵀ on the integer tensor cores
(``path`` says which kernel a shape takes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as kb
from repro_torch.kernels import ref

launches = kb.LaunchCounter("epoch_fused")
#: the float branch's share of ``launches``, counted at the same launch
launches_float = kb.LaunchCounter("epoch_fused_float")

_Q4 = float(255.0 ** 4)


def fitness_plain(S, Q, G, quantized: bool):
    """Per-particle fitness of S (P, N, n, m) on per-problem Q/G, in the
    scaled float units of the float path."""
    if quantized:
        f = ref.edge_fitness_quantized(ref.quantize_s(S), Q[:, None],
                                       G[:, None])
        return ref.fdiv(f, _Q4)
    return ref.edge_fitness(S, Q[:, None], G[:, None])


def epoch_inner_reference(S, V, S_local, f_local, S_star, f_star, S_bar,
                          mask, Q, G, r_all, *, omega, c1, c2, c3, v_max,
                          quantized=False):
    """Plain version of the fused epoch loop, batched over problems.

    ``S/V/S_local`` (P, N, n, m), ``f_local`` (P, N), ``S_star``/
    ``S_bar``/``mask`` (P, n, m), ``f_star`` (P,), ``Q`` (P, n, n), ``G``
    (P, m, m), ``r_all`` (P, K, N, 3) pre-drawn step uniforms. Returns
    ``(S_final, S_star, f_star, f_trace (P, K), f_last (P, N))``; f_last
    is the last step's fitness (``f_local`` when K = 0).
    """
    ref.strict_fp32(S)
    P, N = S.shape[:2]
    K = r_all.shape[1]
    ar = torch.arange(P, device=S.device)
    S = S.float()
    V = V.float()
    S_local = S_local.float()
    f_local = f_local.float()
    S_star = S_star.float()
    f_star = f_star.float()
    mk = mask[:, None]
    f_last = f_local
    trace = []
    for k in range(K):
        S, V = ref.pso_update(S, V, S_local, S_star[:, None], S_bar[:, None],
                              mk, r_all[:, k], omega=omega, c1=c1, c2=c2,
                              c3=c3, v_max=v_max)
        if quantized:
            S = ref.dequantize_s(
                ref.row_normalize_quantized(ref.quantize_s(S), mk))
        f = fitness_plain(S, Q, G, quantized)
        improved = f > f_local
        S_local = torch.where(improved[..., None, None], S, S_local)
        f_local = torch.maximum(f, f_local)
        b = f_local.argmax(-1)
        f_best = f_local[ar, b]
        better = f_best > f_star
        S_star = torch.where(better[:, None, None], S_local[ar, b], S_star)
        f_star = torch.where(better, f_best, f_star)
        trace.append(f_star)
        f_last = f
    f_trace = (torch.stack(trace, 1) if trace
               else torch.zeros(P, 0, dtype=torch.float32, device=S.device))
    return S, S_star, f_star, f_trace, f_last


def path(P: int, N: int, n: int, m: int, quantized: bool) -> int:
    """The step kernel the card runs for P problems of N particles at
    (n, m): C > 0 for ``cluster_step_kernel`` on clusters of C CTAs, 0
    for ``step_kernel``, -1 for ``step_wide_kernel`` (the record read
    from device scratch)."""
    return kb.bind("epoch_fused", "epoch_fused_path", [kb.I_] * 5)(
        P, N, n, m, int(bool(quantized)))


def instantiation(P: int, N: int, n: int, m: int, quantized: bool) -> str:
    """``path`` as the name of the kernel and its cluster size."""
    c = path(P, N, n, m, quantized)
    q = "true" if quantized else "false"
    if c > 0:
        return f"cluster_step_kernel<{q}>, clusters of {c}"
    return f"step_kernel<{q}, *>" if c == 0 else f"step_wide_kernel<{q}, *>"


def epoch_fused_cuda(S, V, S_local, f_local, S_star, f_star, S_bar, mask,
                     Q, G, r_all, *, omega, c1, c2, c3, v_max,
                     quantized=False):
    """Launch the kernels (same arguments and results as
    ``epoch_inner_reference``): one prologue launch and one (N, P) step
    launch per inner step, K + 1 launches counted (0 when K = 0), in
    ``launches_float`` too when the call is the float branch."""
    P, N, n, m = S.shape
    K = r_all.shape[1]
    kb.require(S.is_cuda, "epoch_fused_cuda needs CUDA tensors")
    kb.require(r_all.shape == (P, K, N, 3), "r_all must be (P, K, N, 3)")
    # working state, updated in place by the kernels
    S_w = S.to(torch.float32, copy=True).contiguous()
    V_w = V.to(torch.float32, copy=True).contiguous()
    Sl_w = S_local.to(torch.float32, copy=True).contiguous()
    fl_w = f_local.to(torch.float32, copy=True).contiguous()
    f_last = f_local.to(torch.float32, copy=True).contiguous()
    star_w = S_star.to(torch.float32, copy=True).contiguous()
    fstar_w = f_star.to(torch.float32, copy=True).reshape(P).contiguous()
    S_bar = S_bar.to(torch.float32).contiguous()
    if S_bar.data_ptr() % 16:        # the kernel reads it in 16-byte loads
        S_bar = S_bar.clone()
    mk = (mask != 0).to(torch.uint8).contiguous()
    Qc = Q.to(torch.uint8).contiguous()
    Gc = G.to(torch.uint8).contiguous()
    r = r_all.to(torch.float32).contiguous()
    trace = torch.empty(P, K, dtype=torch.float32, device=S.device)
    q = int(bool(quantized))
    nbytes = kb.bind("epoch_fused", "epoch_fused_scratch_bytes", [kb.I_] * 5,
                     ctypes.c_longlong)(P, N, n, m, q)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=S.device)
    fn = kb.bind("epoch_fused", "epoch_fused",
                 [kb.P_] * 14 + [kb.I_] * 5 + [kb.F_] * 5 + [kb.I_, kb.P_])
    err = fn(*[kb.ptr(t) for t in (S_w, V_w, Sl_w, fl_w, f_last, star_w,
                                   fstar_w, S_bar, mk, Qc, Gc, r, trace,
                                   scratch)],
             P, N, n, m, K, omega, c1, c2, c3, v_max, q, kb.stream())
    kb.check(err, "epoch_fused")
    launches.add(K + 1 if K > 0 else 0)
    if not q:
        launches_float.add(K + 1 if K > 0 else 0)
    return S_w, star_w, fstar_w, trace, f_last
