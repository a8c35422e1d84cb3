"""Seeded inputs and the kernel-against-plain comparison.

``chip_smoke.py`` and the card-only tests hold every hand-written kernel
against its plain version with these helpers: the same inputs (made on
the host from a numpy seed, then moved to the device) go through both,
integer outputs must be equal bit for bit and float outputs must agree
within ``RTOL``/``ATOL`` (the parity contract of the JAX package's
backend sweep).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.epoch_fused import (epoch_fused_cuda,
                                             epoch_inner_reference,
                                             fitness_plain)
from repro_torch.kernels.finish_fused import (epoch_finish_cuda,
                                              epoch_finish_reference)
from repro_torch.kernels.prune_fixpoint import (prune_fixpoint_cuda,
                                                prune_fixpoint_reference)
from repro_torch.kernels.pso_fitness import (
    edge_fitness_cuda, edge_fitness_quantized_reference,
    edge_fitness_reference)

RTOL, ATOL = 1e-5, 1e-4
HYPER = dict(omega=0.7, c1=1.4, c2=1.4, c3=0.6, v_max=0.5)


def random_problem(P: int, n: int, m: int, seed: int,
                   mask_dtype=torch.uint8):
    """P random problems: a DAG query, a sparse DAG target of mean
    degree ~4 (an engine mesh's), and a dense mask with two planted
    singleton rows per problem (work for the injectivity half)."""
    rng = np.random.default_rng(seed)
    Q = np.triu(rng.random((P, n, n)) < min(0.3, 3.0 / n), 1)
    G = np.triu(rng.random((P, m, m)) < min(0.4, 4.0 / m), 1)
    mask = rng.random((P, n, m)) < 0.8
    mask[:, :, 0] = True
    for i, j in ((0, 1), (n // 2, min(3, m - 1))):
        mask[:, i, :] = False
        mask[:, i, j] = True
    return (torch.from_numpy(Q.astype(np.uint8)),
            torch.from_numpy(G.astype(np.uint8)),
            torch.from_numpy(mask).to(mask_dtype))


def swarm_inputs(Q, G, mask, N: int, K: int, seed: int) -> Dict:
    """Particle state for the fitness, epoch and tail kernels on the
    problems ``(Q, G, mask)``: masked row-stochastic S, small velocities,
    the step uniforms and a Gumbel field, on the device of ``mask``."""
    P, n, m = mask.shape
    rng = np.random.default_rng(seed)
    dev = mask.device
    maskf = (mask != 0).float().cpu().numpy()[:, None]
    S = rng.uniform(0.05, 1.0, (P, N, n, m)).astype(np.float32) * maskf
    S = S / np.maximum(S.sum(-1, keepdims=True), 1e-9)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    S = t(S.astype(np.float32))
    f_local = fitness_plain(S, Q, G, False)
    return dict(
        S=S, S_q=ref.quantize_s(S),
        V=t(rng.normal(0.0, 0.1, (P, N, n, m)).astype(np.float32)),
        f_local=f_local, S_star=S[:, 0].clone(),
        f_star=torch.full((P,), -1e6, dtype=torch.float32, device=dev),
        S_bar=S.mean(1), r_all=t(rng.random((P, K, N, 3)).astype(np.float32)),
        gum=t(rng.gumbel(size=(P, N, n, m)).astype(np.float32)))


def kernel_pairs(Q, G, mask, x: Dict, *, quantized: bool, gumbel_tau: float,
                 elite_k: int, refine_iters: int = 6
                 ) -> Dict[str, Tuple[Callable, Callable]]:
    """``{entry: (kernel thunk, plain thunk)}`` for the five entry points
    the slice ports, on one set of inputs."""
    ep = (x["S"], x["V"], x["S"], x["f_local"], x["S_star"], x["f_star"],
          x["S_bar"], mask, Q, G, x["r_all"])
    ep_kw = dict(HYPER, quantized=quantized)
    fin = (x["S"], x["f_local"], x["gum"] if gumbel_tau > 0 else None, mask,
           Q, G)
    fin_kw = dict(gumbel_tau=gumbel_tau, refine_threshold=0.5,
                  refine_iters=refine_iters, elite_k=elite_k,
                  consensus_temp=25.0)
    return {
        "prune_fixpoint": (lambda: prune_fixpoint_cuda(mask, Q, G),
                           lambda: prune_fixpoint_reference(mask, Q, G)),
        "edge_fitness": (lambda: edge_fitness_cuda(x["S"], Q, G),
                         lambda: edge_fitness_reference(x["S"], Q, G)),
        "edge_fitness_quantized": (
            lambda: edge_fitness_cuda(x["S_q"], Q, G, quantized=True),
            lambda: edge_fitness_quantized_reference(x["S_q"], Q, G)),
        "epoch_fused": (lambda: epoch_fused_cuda(*ep, **ep_kw),
                        lambda: epoch_inner_reference(*ep, **ep_kw)),
        "epoch_finish": (lambda: epoch_finish_cuda(*fin, **fin_kw),
                         lambda: epoch_finish_reference(*fin, **fin_kw)),
    }


def compare(got, want) -> float:
    """Hold a kernel's outputs against the plain version's: integers and
    booleans equal, floats within RTOL/ATOL. Returns the largest absolute
    float difference; raises AssertionError on a mismatch."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs, expected {len(want)}")
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {k}: {g.dtype}{tuple(g.shape)}, "
                                 f"expected {w.dtype}{tuple(w.shape)}")
        if w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                       equal_nan=True)
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
        elif not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"output {k}: {bad} integer entries differ")
    return err
