"""The port's numpy plumbing (workload zoo, preemptible DAG, target
graph, compatibility mask, padding) is byte-identical to the JAX
package's on every zoo workload."""
import importlib

import numpy as np
import pytest
import torch

from repro.accel import platform as jplat
from repro.core import graphs as jgraphs
from repro.core import preemptible_dag as jpd
from repro.core.service import shape_bucket as jshape_bucket
from repro.workloads import zoo as jzoo
from repro_torch.accel import platform as tplat
from repro_torch.accel import target_graph as ttg
from repro_torch.core import graphs as tgraphs
from repro_torch.core import preemptible_dag as tpd
from repro_torch.workloads import zoo as tzoo

# the JAX package's accel/__init__ re-exports a function of the same name
jtg = importlib.import_module("repro.accel.target_graph")

FREE_SEED = 0


def _free(engines, n_free=96, seed=FREE_SEED):
    free = np.zeros(engines, dtype=bool)
    free[np.random.default_rng(seed).choice(engines, n_free,
                                            replace=False)] = True
    return free


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_zoo_and_platforms_match():
    assert sorted(tzoo.WORKLOAD_ZOO) == sorted(jzoo.WORKLOAD_ZOO)
    for name in ("edge", "cloud"):
        assert (tplat.get_platform(name).__dict__
                == jplat.get_platform(name).__dict__)


@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("name", sorted(jzoo.WORKLOAD_ZOO))
def test_problem_plumbing_is_byte_identical(name, window):
    jp, tp = jplat.CLOUD, tplat.CLOUD
    cap = jp.engine_tile_capacity_macs()
    jd = jpd.build_preemptible_dag([(0, jzoo.get_workload(name), 0)], cap,
                                   window_stages=window)
    td = tpd.build_preemptible_dag([(0, tzoo.get_workload(name), 0)], cap,
                                   window_stages=window)
    for f in ("adj", "types", "weights"):
        _same(getattr(td.graph, f), getattr(jd.graph, f))
    assert td.task_tiles == jd.task_tiles
    free = _free(jp.engines)
    jt, tt = jtg.free_engine_graph(jp, free), ttg.free_engine_graph(tp, free)
    for f in ("adj", "types", "weights"):
        _same(getattr(tt, f), getattr(jt, f))
    jq, jorder = jgraphs.topological_relabel(jd.graph)
    tq, torder = tgraphs.topological_relabel(td.graph)
    _same(torder, jorder)
    jmask = jgraphs.compatibility_mask(jq, jt)
    tmask = tgraphs.compatibility_mask(tq, tt)
    _same(tmask, jmask)
    bucket = tpd.shape_bucket(tq.n, tt.n)
    assert bucket == jshape_bucket(jq.n, jt.n)
    for a, b in zip(tpd.pad_problem(tq.adj, tt.adj, tmask, *bucket),
                    jpd.pad_problem(jq.adj, jt.adj, jmask, *bucket)):
        _same(a, b)
    Q, G, mask = tgraphs.as_device_graphs(tq, tt, device="cpu")
    assert Q.dtype == G.dtype == mask.dtype == torch.uint8
    _same(mask.numpy(), jmask)


@pytest.mark.parametrize("seed,n,m", [(0, 6, 12), (1, 8, 16), (2, 10, 24)])
def test_planted_fixture_contains_its_query(seed, n, m):
    rng = np.random.default_rng(seed)
    q = tgraphs.random_dag(rng, n, 0.35)
    g = tgraphs.embed_query_in_target(rng, q, m)
    assert q.is_dag() and g.is_dag()
    # the JAX package's exhaustive oracle finds the planted embedding
    from repro.core import ullmann
    assert ullmann.count_monomorphisms(
        q.adj, g.adj, jgraphs.compatibility_mask(q, g), limit=1) > 0
