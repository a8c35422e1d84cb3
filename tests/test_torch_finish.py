"""The port's plain epoch tail against the JAX package's, on inputs that
pin the order of ties.

The CUDA kernel of ``epoch_finish`` takes every argmax of its three
projection chains with warp shuffles and keeps a per-row best column for
the greedy projection; on the card it is held bit for bit against
``epoch_finish_reference``. Here that plain version, and the plain greedy
and structured projections it is built from, are held against the JAX
package on the CPU where ties are everywhere: S drawn from a set of four
values, and mask rows with no candidate at all. Integer outputs must be
equal bit for bit, S̄ within rtol 1e-5 / atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import get_backend as jax_backend
from repro_torch.kernels import ref as tref
from repro_torch.kernels.finish_fused import epoch_finish_reference

jax.config.update("jax_platform_name", "cpu")

# (P, N, n, m): one shape on multiples of 8 and one off them
SHAPES = [(2, 4, 8, 16), (2, 3, 13, 37)]
TIES = (0.1, 0.2, 0.3, 0.4)
_FIN = dict(refine_threshold=0.5, refine_iters=2, consensus_temp=25.0)


def _inputs(P, N, n, m, seed, empty_rows):
    """Tie-heavy S on a random DAG pair; ``empty_rows`` zeroes two mask
    rows of every problem."""
    rng = np.random.default_rng(seed)
    Q = np.triu(rng.random((P, n, n)) < 0.3, 1).astype(np.uint8)
    G = np.triu(rng.random((P, m, m)) < 0.4, 1).astype(np.uint8)
    mask = (rng.random((P, n, m)) < 0.8).astype(np.uint8)
    mask[:, :, 0] = 1
    if empty_rows:
        mask[:, 1] = 0
        mask[:, n - 2] = 0
    S = np.asarray(TIES, np.float32)[rng.integers(0, len(TIES),
                                                  (P, N, n, m))]
    S = (S * mask[:, None]).astype(np.float32)
    f = np.asarray(TIES, np.float32)[rng.integers(0, len(TIES), (P, N))]
    gum = rng.gumbel(size=(P, N, n, m)).astype(np.float32)
    return dict(S=S, f=f, gum=gum, mask=mask, Q=Q, G=G)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tau", [0.0, 0.3])
@pytest.mark.parametrize("empty_rows", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_epoch_finish_reference_matches_jax(shape, empty_rows, tau):
    a = _inputs(*shape, seed=sum(shape), empty_rows=empty_rows)
    kw = dict(_FIN, gumbel_tau=tau, elite_k=max(1, shape[1] // 2))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = epoch_finish_reference(t["S"], t["f"], t["gum"] if tau else None,
                                 t["mask"], t["Q"], t["G"], **kw)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = jax_backend("ref").epoch_finish_batch(
        j["S"], j["f"], j["gum"] if tau else None, j["mask"], j["Q"],
        j["G"], **kw)
    _assert_equal([x.numpy() for x in got], want)


@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_epoch_finish_reference_matches_jax_interpret(tau):
    """The Pallas kernel itself, in interpret mode, on ties and empty
    rows at the smallest shape."""
    a = _inputs(*SHAPES[0], seed=5, empty_rows=True)
    kw = dict(_FIN, gumbel_tau=tau, elite_k=2)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = epoch_finish_reference(t["S"], t["f"], t["gum"] if tau else None,
                                 t["mask"], t["Q"], t["G"], **kw)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = jax_backend("interpret").epoch_finish_batch(
        j["S"], j["f"], j["gum"] if tau else None, j["mask"], j["Q"],
        j["G"], **kw)
    _assert_equal([x.numpy() for x in got], want)


@pytest.mark.parametrize("empty_rows", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_projections_match_jax_on_ties(shape, empty_rows):
    """The greedy and the structured projection of every particle: the
    tie order the kernel's chains reproduce."""
    a = _inputs(*shape, seed=sum(shape) + 1, empty_rows=empty_rows)
    jref = jax_backend("ref")
    P, N = shape[:2]
    for p in range(P):
        t = {k: torch.from_numpy(a[k][p]) for k in ("S", "mask", "Q", "G")}
        got_g = tref.greedy_project(t["S"], t["mask"])
        got_s = tref.structured_project(t["S"], t["Q"], t["G"], t["mask"])
        for b in range(N):
            S = jnp.asarray(a["S"][p, b])
            mk, Q, G = (jnp.asarray(a[k][p]) for k in ("mask", "Q", "G"))
            _assert_equal([got_g[b].numpy(), got_s[b].numpy()],
                          [jref.greedy_project(S, mk),
                           jref.structured_project(S, Q, G, mk)])
