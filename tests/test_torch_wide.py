"""Past n, m = 256: the plain versions of the five kernels that carry
``pso.match``, ``pso.match_batch`` and ``revalidate_batch``, and of the
split epoch's four, against the JAX package's ``ref`` backend at
(300, 400) and (257, 771), and one ``match_batch`` of deepseek-7b mapped
whole on a 512-engine platform (bucket (312, 528)) against the
reference's on its draws.

The JAX package pads to multiples of 128 and takes any n, m; on the card
the port's kernels take these shapes through their wide instantiations
(``csrc/common.cuh``), held bit for bit against the same plain versions
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 3. The swarm
is small here (a CPU runs the reference); the shapes are the card's.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pso as jpso
from repro.kernels import get_backend as jax_backend
from repro.kernels import ref as jref
from repro_torch.accel import platform as tplat
from repro_torch.accel import target_graph as ttg
from repro_torch.core import graphs as tgraphs
from repro_torch.core import preemptible_dag as tpd
from repro_torch.core import pso as tpso
from repro_torch.kernels import backend as tb
from repro_torch.workloads import zoo as tzoo
from test_torch_kernels import JAX_CASES, TORCH_CASES, _Problem, assert_parity
from test_torch_pso import _close, batch_draws

jax.config.update("jax_platform_name", "cpu")

#: the kernels of the main path, by their batched entries
MAIN = ("prune_fixpoint_batch", "edge_fitness", "edge_fitness_quantized",
        "epoch_fused_batch", "epoch_finish_batch")
#: the split epoch's four (``core/split_epoch.py``)
SPLIT = ("pso_update", "ullmann_refine_step", "greedy_project",
         "masked_argmax")
WIDE_SHAPES = [(2, 300, 400), (2, 257, 771)]
#: a 512-engine accelerator (16 x 32 NoC); the reference names none
CLOUD_512 = dataclasses.replace(tplat.CLOUD, name="cloud-512", engines=512,
                                noc_rows=16, noc_cols=32)


@pytest.mark.parametrize("B,n,m", WIDE_SHAPES)
@pytest.mark.parametrize("kernel", MAIN + SPLIT)
def test_plain_versions_match_jax_ref_past_256(kernel, B, n, m):
    """Integers bit for bit, floats within rtol 1e-5 / atol 1e-4."""
    p = _Problem(zlib.crc32(repr((kernel, B, n, m)).encode()), B, n, m,
                 "uint8")
    got = TORCH_CASES[kernel](tb.get_backend("ref"), p.view(torch.from_numpy))
    want = JAX_CASES[kernel](jax_backend("ref"), p.view(jnp.asarray))
    assert_parity(got, want)


def _deepseek_on_cloud_512():
    """deepseek-7b mapped whole (``window_stages=256``) against the whole
    free engine graph of ``CLOUD_512``, relabelled and padded to its
    bucket as the service pads it."""
    g = ttg.free_engine_graph(CLOUD_512, np.ones(CLOUD_512.engines, bool))
    pd = tpd.build_preemptible_dag(
        [(0, tzoo.get_workload("deepseek-7b"), 0)],
        CLOUD_512.engine_tile_capacity_macs(), window_stages=256)
    q = tgraphs.topological_relabel(pd.graph)[0]
    bucket = tpd.shape_bucket(q.n, g.n)
    padded = tpd.pad_problem(q.adj, g.adj, tgraphs.compatibility_mask(q, g),
                             *bucket)
    return q, g, bucket, tuple(np.stack([x]) for x in padded)


def test_match_batch_on_cloud_512_matches_jax():
    """The (312, 528) problem from the JAX key: the same epochs_run,
    prune_sweeps, per-epoch feasible flags and mappings, and every
    mapping found feasible under the reference's ``ref.is_feasible``."""
    q, g, bucket, (Qb, Gb, Mb) = _deepseek_on_cloud_512()
    assert (q.n, g.n, bucket) == (308, 512, (312, 528))
    kw = dict(num_particles=4, epochs=2, inner_steps=2, quantized=True,
              early_exit=True, backend="ref")
    jcfg, tcfg = jpso.PSOConfig(**kw), tpso.PSOConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    jo = jpso.match_batch(keys, jnp.asarray(Qb), jnp.asarray(Gb),
                          jnp.asarray(Mb), jcfg)
    to = tpso.match_batch(torch.from_numpy(Qb), torch.from_numpy(Gb),
                          torch.from_numpy(Mb), tcfg,
                          draws=batch_draws(keys, jcfg, *Mb.shape[1:]))
    for k in ("epochs_run", "prune_sweeps", "feasible", "mappings"):
        _close(to[k], jo[k])
    for b in np.where(to["feasible"].numpy().any(axis=(0, 2)))[0]:
        assert bool(jref.is_feasible(jnp.asarray(to["mappings"][b].numpy()),
                                     jnp.asarray(Qb[b]), jnp.asarray(Gb[b])))


def test_plain_quantized_fitness_largest_sums_past_256():
    """The plain quantized fitness with a dense G at m = 528, the contract
    that the card kernel's byte planes of S G are held to: an all-255
    tile (S G = 134,640, three bytes; S G Sᵀ ≈ 1.8e10; the int64 squares
    wrap) bit for bit an exact numpy int64 computation, and a tile whose
    rows sum to at most 16,896 (S G past 2^8, two bytes) too, and within
    float32 rounding of the JAX package's ``ref`` backend. That backend
    sums S G Sᵀ in int32 and the squares in float32: it holds the second
    tile (S G Sᵀ ≤ 2.9e8, the squares' sum below 2^63, where the int64 sum
    does not wrap either) and wraps on the first, which is left out of
    that comparison."""
    from repro_torch.kernels.pso_fitness import (
        edge_fitness_quantized_reference)
    n, m, N = 8, 528, 2
    rng = np.random.default_rng(528)
    Q = np.triu(rng.random((n, n)) < 0.5, 1).astype(np.uint8)
    G = np.ones((m, m), np.uint8)
    tiles = {"all_255": (np.full((N, n, m), 255, np.uint8), 3),
             "two_bytes": (rng.integers(20, 33, (N, n, m), dtype=np.uint8),
                           2)}
    for name, (S, nbytes) in tiles.items():
        S64 = S.astype(np.int64)
        SG = S64 @ G.astype(np.int64)
        assert 1 << 8 * (nbytes - 1) <= SG.max() < 1 << 8 * nbytes, name
        resid = Q.astype(np.int64) * 255 * 255 - SG @ S64.transpose(0, 2, 1)
        with np.errstate(over="ignore"):
            want = -(resid * resid).sum((1, 2)).astype(np.float32)
        got = edge_fitness_quantized_reference(
            torch.from_numpy(S)[None], torch.from_numpy(Q)[None],
            torch.from_numpy(G)[None])[0].numpy()
        assert np.array_equal(got, want), (name, got, want)
        if name == "two_bytes":
            jx = np.asarray(jax_backend("ref").edge_fitness_quantized(
                jnp.asarray(S), jnp.asarray(Q), jnp.asarray(G)))
            np.testing.assert_allclose(got, jx, rtol=1e-5)
