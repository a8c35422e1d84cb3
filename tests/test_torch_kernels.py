"""Parity of the port's kernel seam with the JAX package's.

Every entry of ``KERNEL_NAMES`` runs through the port's ``ref`` suite and
the JAX ``ref`` suite on the same numpy-made inputs, at the JAX backend
sweep's shapes, for uint8 and int32 masks: integer outputs equal bit for
bit, float outputs within rtol 1e-5 / atol 1e-4 (the contract of
``tests/test_backend.py``). Every kernel entry is also held once against
the JAX Pallas kernel in interpret mode at the smallest shape, and the
dispatch layer's CPU path is the plain version.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import KERNEL_NAMES as JAX_KERNEL_NAMES
from repro.kernels import get_backend as jax_backend
from repro_torch.kernels import backend as tb

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(1, 8, 16), (2, 40, 72)]
MASK_DTYPES = ["uint8", "int32"]
_HYPER = dict(omega=0.7, c1=1.4, c2=1.4, c3=0.6, v_max=0.5)


class _Problem:
    """One random matching instance with planted singleton rows, made
    with numpy; ``view(np_to)`` hands the same arrays to one framework."""

    def __init__(self, seed, B, n, m, mask_dtype):
        rng = np.random.default_rng(seed)
        S = rng.random((B, n, m), dtype=np.float32)
        S = (S / S.sum(-1, keepdims=True)).astype(np.float32)
        Q = np.triu(rng.random((n, n)) < 0.3, 1).astype(np.uint8)
        G = np.triu(rng.random((m, m)) < 0.4, 1).astype(np.uint8)
        mask = rng.random((n, m)) < 0.8
        mask[:, 0] = True
        for i, j in ((0, 1), (n // 2, min(3, m - 1))):
            mask[i, :] = False
            mask[i, j] = True
        mask = mask.astype(mask_dtype)
        r = rng.random((B, 3), dtype=np.float32)
        self.a = dict(
            S=S, S_q=np.asarray(jax_backend("ref").quantize_s(jnp.asarray(S))),
            Q=Q, G=G, mask=mask, Mb=np.broadcast_to(mask, (B, n, m)).copy(),
            V=(rng.standard_normal((B, n, m)) * 0.1).astype(np.float32),
            r=r, f_local=-(S * S).sum((1, 2)).astype(np.float32),
            r_steps=np.stack([r * w for w in (0.25, 0.5, 0.75)]),
            gum=rng.gumbel(size=(B, n, m)).astype(np.float32),
            M_hat=np.asarray(jax_backend("ref").greedy_project(
                jnp.asarray(S[0]), jnp.asarray(mask))))

    def view(self, to):
        return type("P", (), {k: to(np.array(v)) for k, v in self.a.items()})


def _epoch_args(p):
    return (p.S, p.V, p.S, p.f_local, p.S[0], p.f_local[0] * 0 - 1e6,
            p.S.mean(0), p.mask, p.Q, p.G, p.r_steps)


def _batch_args(p, stack, roll):
    two = lambda x, r=False: stack([x, roll(x) if r else x])
    return (two(p.S, True), two(p.V, True), two(p.S, True), two(p.f_local),
            two(p.S[0], True), two(p.f_local[0] * 0 - 1e6),
            two(p.S.mean(0), True), two(p.mask, True), two(p.Q), two(p.G),
            two(p.r_steps))


def _finish_batch_args(p, stack, roll):
    two = lambda x, r=False: stack([x, roll(x) if r else x])
    return (two(p.S, True), two(p.f_local), None, two(p.mask, True),
            two(p.Q), two(p.G))


_FIN = dict(refine_threshold=0.5, refine_iters=2, consensus_temp=25.0)


def _cases(stack, roll):
    return {
        "edge_fitness": lambda bk, p: bk.edge_fitness(p.S, p.Q, p.G),
        "edge_fitness_quantized":
            lambda bk, p: bk.edge_fitness_quantized(p.S_q, p.Q, p.G),
        "pso_update": lambda bk, p: bk.pso_update(
            p.S, p.V, p.S, p.S[0], p.S.mean(0), p.mask, p.r, **_HYPER),
        "ullmann_refine_step":
            lambda bk, p: bk.ullmann_refine_step(p.Mb, p.Q, p.G),
        "greedy_project": lambda bk, p: bk.greedy_project(p.S[0], p.mask),
        "masked_argmax": lambda bk, p: bk.masked_argmax(p.S[0], p.mask),
        "structured_project":
            lambda bk, p: bk.structured_project(p.S[0], p.Q, p.G, p.mask),
        "injectivity_prune": lambda bk, p: bk.injectivity_prune(p.mask),
        "is_feasible": lambda bk, p: bk.is_feasible(p.M_hat, p.Q, p.G),
        "prune_fixpoint": lambda bk, p: bk.prune_fixpoint(p.mask, p.Q, p.G),
        "prune_fixpoint_batch": lambda bk, p: bk.prune_fixpoint_batch(
            p.Mb, stack([p.Q] * p.Mb.shape[0]),
            stack([p.G] * p.Mb.shape[0])),
        "epoch_fused": lambda bk, p: bk.epoch_fused(*_epoch_args(p),
                                                    **_HYPER),
        "epoch_fused_batch": lambda bk, p: bk.epoch_fused_batch(
            *_batch_args(p, stack, roll), quantized=True, **_HYPER),
        "epoch_finish": lambda bk, p: bk.epoch_finish(
            p.S, p.f_local, p.gum, p.mask, p.Q, p.G, gumbel_tau=0.3,
            elite_k=max(1, p.S.shape[0] // 2), **_FIN),
        "epoch_finish_batch": lambda bk, p: bk.epoch_finish_batch(
            *_finish_batch_args(p, stack, roll), gumbel_tau=0.0,
            elite_k=max(1, p.S.shape[0] // 2), **_FIN),
        "quantize_s": lambda bk, p: bk.quantize_s(p.S),
        "dequantize_s": lambda bk, p: bk.dequantize_s(p.S_q),
        "row_normalize_quantized":
            lambda bk, p: bk.row_normalize_quantized(p.S_q[0], p.mask),
    }


JAX_CASES = _cases(jnp.stack, lambda x: jnp.roll(x, 1, axis=-1))
TORCH_CASES = _cases(torch.stack, lambda x: torch.roll(x, 1, dims=-1))


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    return [np.asarray(x.numpy() if torch.is_tensor(x) else x)]


def assert_parity(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w)


def test_kernel_names_match_the_jax_package():
    assert tb.KERNEL_NAMES == tuple(JAX_KERNEL_NAMES)
    assert set(TORCH_CASES) == set(tb.KERNEL_NAMES)
    for name in tb.registered_backends():
        for k in tb.KERNEL_NAMES:
            assert callable(getattr(tb.get_backend(name), k))
    assert tb.get_backend("auto").name == "cuda"


@pytest.mark.parametrize("mask_dtype", MASK_DTYPES)
@pytest.mark.parametrize("B,n,m", SHAPES)
@pytest.mark.parametrize("kernel", sorted(TORCH_CASES))
def test_port_ref_matches_jax_ref(kernel, B, n, m, mask_dtype):
    p = _Problem(zlib.crc32(repr((kernel, B, n, m)).encode()), B, n, m,
                 mask_dtype)
    got = TORCH_CASES[kernel](tb.get_backend("ref"), p.view(torch.from_numpy))
    want = JAX_CASES[kernel](jax_backend("ref"), p.view(jnp.asarray))
    assert_parity(got, want)


PORTED = ["prune_fixpoint_batch", "edge_fitness", "edge_fitness_quantized",
          "epoch_fused", "epoch_fused_batch", "epoch_finish",
          "epoch_finish_batch", "pso_update", "ullmann_refine_step",
          "greedy_project", "masked_argmax"]


@pytest.mark.parametrize("kernel", PORTED)
def test_port_matches_jax_interpret_and_dispatch_is_plain_on_cpu(kernel):
    """Smallest shape: the cuda suite (which on CPU tensors runs the
    plain version, launching nothing) against the Pallas kernel in
    interpret mode."""
    p = _Problem(3, 1, 8, 16, "uint8")
    before = {k: c.count for k, c in _counters().items()}
    got = TORCH_CASES[kernel](tb.get_backend("cuda"), p.view(torch.from_numpy))
    want = JAX_CASES[kernel](jax_backend("interpret"), p.view(jnp.asarray))
    assert_parity(got, want)
    assert {k: c.count for k, c in _counters().items()} == before


def _counters():
    from repro_torch.kernels import (argmax_project, epoch_fused,
                                     finish_fused, prune_fixpoint,
                                     pso_fitness, pso_update, ullmann_refine)
    return {c.name: c for c in (epoch_fused.launches,
                                epoch_fused.launches_float,
                                finish_fused.launches,
                                prune_fixpoint.launches, pso_fitness.launches,
                                pso_fitness.launches_quantized,
                                pso_update.launches, ullmann_refine.launches,
                                argmax_project.launches_greedy,
                                argmax_project.launches_argmax)}


@pytest.mark.parametrize("max_iters", [0, 2])
def test_fixpoint_helpers_match_jax(max_iters):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    p = _Problem(7, 1, 12, 20, "uint8")
    t, j = p.view(torch.from_numpy), p.view(jnp.asarray)
    assert_parity(tref.ullmann_refine_fixpoint(t.mask, t.Q, t.G, max_iters),
                  jref.ullmann_refine_fixpoint(j.mask, j.Q, j.G, max_iters))
    assert_parity(tref.prune_mask_fixpoint(t.mask, t.Q, t.G, max_iters),
                  jref.prune_mask_fixpoint(j.mask, j.Q, j.G, max_iters))



def _jax_prune(mask, Q, G, max_iters=0):
    """The JAX ``ref`` pre-prune, one problem at a time."""
    from repro.kernels import ref as jref
    outs = [jref.prune_fixpoint_count(jnp.asarray(mk.numpy()),
                                      jnp.asarray(q.numpy()),
                                      jnp.asarray(g.numpy()), max_iters)
            for mk, q, g in zip(mask, Q, G)]
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("case", ["random_203x233", "chain_13x37",
                                  "chain_40x72"])
def test_port_prune_matches_jax_ref_large_and_long(case, mask_dtype):
    """The port's plain pre-prune (masks and sweeps) against the JAX
    ``ref`` one where the card's kernel keeps 7 rows a warp (203 x 233) and
    on path-shaped problems whose fixpoint takes ~n sweeps."""
    from repro_torch.kernels import cases
    from repro_torch.kernels import ref as tref
    kind, shape = case.split("_")
    n, m = map(int, shape.split("x"))
    make = cases.random_problem if kind == "random" else cases.chain_problem
    Q, G, mask = make(1 if kind == "random" else 3, n, m, 43, mask_dtype)
    got = tref.prune_fixpoint_count(mask, Q, G)
    assert_parity(got, _jax_prune(mask, Q, G))
    if kind == "chain":        # n sweeps from the all-ones mask
        assert int(got[1][0]) == n


@pytest.mark.parametrize("case", ["random_203x233", "chain_40x72"])
def test_port_edge_fitness_matches_jax_ref_large(case):
    """The port's plain float fitness against the JAX ``ref`` one at
    (P, N, n, m) = (1, 2, 203, 233), where the card's kernel keeps its
    tiles in device scratch, and on the long-chain problem."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import cases
    from repro_torch.kernels.pso_fitness import edge_fitness_reference
    kind, shape = case.split("_")
    n, m = map(int, shape.split("x"))
    make = cases.random_problem if kind == "random" else cases.chain_problem
    Q, G, mask = make(1, n, m, 44)
    S = cases.swarm_inputs(Q, G, mask, 2, 1, seed=44)["S"]
    got = edge_fitness_reference(S, Q, G)
    want = jax.vmap(jref.edge_fitness, in_axes=(0, None, None))(
        jnp.asarray(S[0].numpy()), jnp.asarray(Q[0].numpy()),
        jnp.asarray(G[0].numpy()))
    assert_parity(got[0], want)
