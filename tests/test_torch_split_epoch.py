"""The port's split (pre-fusion) epoch against the JAX package's, and
against the port's own fused epoch.

The JAX counterparts are the loose scan and the split tail of
``benchmarks/bench_epoch.py`` (``_make_loose_fn``, ``_make_split_tail_fn``)
at that bench's ``--smoke`` sizes (N = 8, n = 10, m = 20, K = 4), on the
``ref`` suite, float and quantized, with inputs made from a numpy seed:
integer outputs equal, float outputs within rtol 1e-5 / atol 1e-4, and
once past n, m = 256 (where the four kernels of the split epoch take
their wide instantiations on the card). On the same draws the port's
split epoch equals its fused ``run_epoch`` bit for bit on every
loose-scan output.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pso as jpso
from repro.kernels import get_backend as jax_backend
from repro_torch.core import graphs as tgraphs
from repro_torch.core import pso as tpso
from repro_torch.core import split_epoch as tsplit

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from benchmarks.bench_epoch import (_make_loose_fn,  # noqa: E402
                                    _make_split_tail_fn)

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4
N, n, m, K = 8, 10, 20, 4
#: (N, n, m, K) of the case past n, m = 256: a small swarm, quantized
WIDE = (4, 260, 300, 2)


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _inputs(seed, N=N, n=n, m=m, K=K):
    """A planted problem and a mid-swarm state, as ``_epoch_inputs``
    makes them, from a numpy seed: (S, V, S_local, f_local, S*, f*, S̄,
    mask, Q, G, r_all) as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = tgraphs.random_dag(rng, n, 0.35)
    g = tgraphs.embed_query_in_target(rng, q, m)
    Q, G = q.adj.astype(np.uint8), g.adj.astype(np.uint8)
    mask = np.asarray(tgraphs.compatibility_mask(q, g), dtype=np.uint8)
    u = rng.random((N, n, m), dtype=np.float32) * mask[None]
    S = (u / np.maximum(u.sum(-1, keepdims=True), 1e-9)).astype(np.float32)
    V = (rng.standard_normal((N, n, m)) * 0.1).astype(np.float32)
    f_local = (-rng.random(N) * 100).astype(np.float32)
    r_all = rng.random((K, N, 3), dtype=np.float32)
    return (S, V, S, f_local, S[0], np.float32(-1e6), S.mean(0), mask, Q,
            G, r_all)


def _cfg(quantized, backend="ref", N=N, K=K, **kw):
    return tpso.PSOConfig(num_particles=N, inner_steps=K,
                          quantized=quantized, backend=backend, **kw)


def _torch(args):
    return tuple(torch.from_numpy(np.array(a)) for a in args)


@pytest.mark.parametrize("quantized", [False, True])
def test_loose_epoch_matches_jax_loose_scan(quantized):
    args = _inputs(1)
    want = _make_loose_fn("ref", quantized, N, K)(
        *(jnp.asarray(a) for a in args))
    got = tsplit.loose_epoch(*_torch(args), _cfg(quantized))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("quantized", [False, True])
def test_split_tail_matches_jax_split_tail(quantized):
    S, *_, mask, Q, G, _ = _inputs(2)
    want = _make_split_tail_fn("ref", quantized, N)(
        jnp.asarray(S), jnp.asarray(mask), jnp.asarray(Q), jnp.asarray(G))
    got = tsplit.split_tail(*_torch((S, mask, Q, G)), _cfg(quantized))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.bool
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("quantized", [False, True])
def test_split_epoch_equals_fused_run_epoch_on_the_same_draws(quantized):
    """The port's twin of the JAX package's legacy-scan test: the fused
    ``run_epoch`` (prologue, ``epoch_fused``, ``epoch_finish``) and the
    split epoch started from the same prologue agree bit for bit on the
    loose scan's outputs and on the tail's."""
    S0, *_, mask, Q, G, _ = _torch(_inputs(3))
    cfg = _cfg(quantized)
    rng = np.random.default_rng(4)
    draws = dict(
        init=torch.from_numpy(
            rng.uniform(0.05, 1.0, (N, n, m)).astype(np.float32)),
        steps=torch.from_numpy(rng.random((K, N, 3), dtype=np.float32)))
    carry0 = tpso.default_carry(mask)
    (S_star, f_star, S_bar), outs = tpso.run_epoch(carry0, draws, Q, G, mask,
                                                   cfg)
    d1 = {k: v[None] for k, v in draws.items()}
    S, V, f_local, S_star0, f_star0 = tpso._epoch_start(
        tpso._batch1(carry0), d1, Q[None], G[None], mask[None], cfg)
    got = tsplit.split_epoch(S[0], V[0], S[0], f_local[0], S_star0[0],
                             f_star0[0], carry0[2], mask, Q, G,
                             draws["steps"], cfg)
    want = (outs["S_final"], S_star, f_star, outs["f_star_trace"],
            outs["fitness"], outs["mappings"], outs["feasible"], S_bar)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k
    # the tail's recompute equals the scan's last-step fitness
    assert torch.equal(tpso._fitness(got[0], Q, G, cfg), got[4])


def test_split_epoch_matches_jax_past_256():
    """``loose_epoch`` and ``split_tail`` against ``_make_loose_fn`` and
    ``_make_split_tail_fn`` at (n, m) = (260, 300), quantized, the tail
    on the loose scan's final swarm."""
    wN, wn, wm, wK = WIDE
    args = _inputs(7, wN, wn, wm, wK)
    cfg = _cfg(True, N=wN, K=wK)
    want = _make_loose_fn("ref", True, wN, wK)(*(jnp.asarray(a)
                                                for a in args))
    got = tsplit.loose_epoch(*_torch(args), cfg)
    assert got[0].shape == (wN, wn, wm)
    for g, w in zip(got, want):
        _close(g, w)
    S = got[0].numpy()
    mask, Q, G = args[7:10]
    want = _make_split_tail_fn("ref", True, wN)(
        jnp.asarray(S), jnp.asarray(mask), jnp.asarray(Q), jnp.asarray(G))
    got = tsplit.split_tail(*_torch((S, mask, Q, G)), cfg)
    for g, w in zip(got, want):
        _close(g, w)


def test_maybe_requantize_and_refine_candidates_match_jax():
    S, *_, mask, Q, G, _ = _inputs(5)
    jS, jmask, jQ, jG = (jnp.asarray(a) for a in (S, mask, Q, G))
    tS, tmask, tQ, tG = _torch((S, mask, Q, G))
    for quantized in (False, True):
        jcfg = jpso.PSOConfig(num_particles=N, quantized=quantized,
                              backend="ref")
        got = tpso._maybe_requantize(tS, tmask, _cfg(quantized))
        _close(got, jpso._maybe_requantize(jS, jmask, jcfg))
    M_proj = np.stack([np.asarray(jax_backend("ref").greedy_project(
        jS[i], jmask)) for i in range(N)])
    jcfg = jpso.PSOConfig(num_particles=N, backend="ref")
    want = jpso.ullmann_refine_candidates(jS, jnp.asarray(M_proj), jQ, jG,
                                          jmask, jcfg)
    got = tpso.ullmann_refine_candidates(tS, torch.from_numpy(M_proj), tQ,
                                         tG, tmask, _cfg(False))
    for g, w in zip(got, want):
        _close(g, w)
