"""The port's twin of ``tests/test_fuzz.py``: the same seeded invariant
fuzzing through the port's scenario registry, simulator and matcher
service, on the CPU, with a fixed small example count so that it runs
in the default lane (no ``fuzz`` mark).

The scenario specs are drawn with the reference's own strategies
(``stream_specs``, ``scenario_specs``, imported from ``test_fuzz.py``)
and built by ``repro_torch.sched.registry``. The seven properties of
``test_fuzz.py`` hold:

  * no scheduler double-books an engine and ``SimConfig.validate``
    holds;
  * IMMSched's tier counts sum to ``sched_matcher_decisions``;
  * streaming and materialized scenarios give equal ``SimResult``s;
  * the heap loop equals ``run_legacy``;
  * a rebuild from the registry is deterministic;
  * the service never serves an infeasible mapping (checked with the
    JAX ``ref.is_feasible``);
  * a snapshot taken mid-run restores bit for bit, and the real-mode
    invariants hold on ``device="cpu"``;

and one across the packages: each analytic spec drawn gives the
reference's ``SimResult`` bit for bit (minus wall clocks).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.sched import SimConfig as JSimConfig
from repro.sched import Simulator as JSimulator
from repro.sched import get_scheduler as jget_scheduler
from repro.accel import EDGE as JEDGE
from repro.sched.registry import build_scenario as jbuild_scenario
from repro_torch.accel.platform import EDGE
from repro_torch.accel.target_graph import free_engine_signature
from repro_torch.core import graphs, pso
from repro_torch.core.service import MatcherService
from repro_torch.sched.registry import build_scenario
from repro_torch.sched.schedulers import SCHEDULERS, get_scheduler
from repro_torch.sched.simulator import SimConfig, Simulator
from repro_torch.sched.tasks import Scenario
from test_fuzz import scenario_specs
from test_scenario_registry import _task_rec
from test_torch_sched import _comparable, _diff
from test_torch_service import _check_mapping

jax.config.update("jax_platform_name", "cpu")

#: examples per property: fixed, so the file's time is
EXAMPLES = 4

#: the reference's fuzz swarm
FUZZ_CFG = pso.PSOConfig(num_particles=16, epochs=2, inner_steps=6,
                         early_exit=True)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port: its many small products can
    spend minutes in OpenMP's barriers when other processes load every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fuzz_settings(n=EXAMPLES):
    return settings(max_examples=n, deadline=None, derandomize=True,
                    database=None)


def _cfg(**kw):
    return SimConfig(platform=EDGE, matcher_mode="analytic", device="cpu",
                     **kw)


# ---------------------------------------------------------------------------
# simulator invariants
# ---------------------------------------------------------------------------

@fuzz_settings()
@given(scenario_specs(), st.sampled_from(sorted(SCHEDULERS)))
def test_fuzz_sim_invariants(spec, sched_name):
    sc = build_scenario(spec)
    r = Simulator(_cfg(validate=True), get_scheduler(sched_name)).run(sc)
    assert not r.truncated
    assert r.alloc_conflicts == 0
    assert 0 <= r.finished <= r.total == len(sc.tasks)
    assert r.deadline_met <= r.finished
    assert r.urgent_met <= r.urgent_total <= r.total
    assert r.busy_integral <= EDGE.engines * r.sim_horizon + 1e-9
    p = r.percentiles or {}
    if "sched_p50" in p:
        assert p["sched_p50"] <= p["sched_p99"] <= p["sched_p999"]
    if sched_name == "immsched":
        ms = r.matcher_stats
        tiers = sum(ms[f"sched_tier{i}_decisions"] for i in range(3))
        assert tiers == ms["sched_matcher_decisions"]


@fuzz_settings()
@given(scenario_specs(), st.sampled_from(sorted(SCHEDULERS)))
def test_fuzz_analytic_equals_the_reference(spec, sched_name):
    """The port's registry and simulator against the reference's on the
    same drawn spec and scheduler."""
    got = Simulator(_cfg(validate=True),
                    get_scheduler(sched_name)).run(build_scenario(spec))
    want = JSimulator(JSimConfig(platform=JEDGE, matcher_mode="analytic",
                                 validate=True),
                      jget_scheduler(sched_name)).run(jbuild_scenario(spec))
    assert not _diff(_comparable(got), _comparable(want))


@fuzz_settings()
@given(scenario_specs(allow_replay=False, single_stream=True))
def test_fuzz_streaming_equals_materialized(spec):
    mat = build_scenario({**spec, "stream": False})
    stm = build_scenario({**spec, "stream": True})
    ra = Simulator(_cfg(validate=True), get_scheduler("immsched")).run(mat)
    rb = Simulator(_cfg(validate=True), get_scheduler("immsched")).run(stm)
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)


@fuzz_settings()
@given(scenario_specs(), st.sampled_from(["immsched", "prema", "cdmsa"]))
def test_fuzz_heap_loop_equals_legacy(spec, sched_name):
    ra = Simulator(_cfg(validate=True),
                   get_scheduler(sched_name)).run(build_scenario(spec))
    rb = Simulator(_cfg(validate=True),
                   get_scheduler(sched_name)).run_legacy(
                       build_scenario(spec))
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)


@fuzz_settings()
@given(scenario_specs())
def test_fuzz_registry_rebuild_deterministic(spec):
    a, b = build_scenario(spec), build_scenario(spec)
    assert (a.name, a.horizon, a.restarts) == (b.name, b.horizon,
                                               b.restarts)
    assert [_task_rec(t) for t in a.tasks] == \
        [_task_rec(t) for t in b.tasks]
    # re-materializing a's tasks into a fresh scenario must not disturb
    # a's ids
    ids = [t.task_id for t in a.tasks]
    if a.tasks:
        early = dataclasses.replace(a.tasks[0], arrival=0.0, task_id=-1)
        Scenario(name="merged", tasks=[early] + list(a.tasks),
                 horizon=a.horizon)
        assert [t.task_id for t in a.tasks] == ids


# ---------------------------------------------------------------------------
# matcher service: feasibility + snapshot round trips under drift
# ---------------------------------------------------------------------------

def _planted(seed, n=6, m=12, edge_prob=0.35):
    rng = np.random.default_rng(seed)
    q = graphs.random_dag(rng, n, edge_prob)
    return q, graphs.embed_query_in_target(rng, q, m)


@pytest.fixture(scope="module")
def service():
    return MatcherService(FUZZ_CFG, device="cpu", persist_dir=False)


@pytest.fixture(scope="module")
def snap_service(tmp_path_factory):
    return MatcherService(FUZZ_CFG, device="cpu",
                          persist_dir=str(tmp_path_factory.mktemp("snap")))


@fuzz_settings()
@given(st.integers(0, 7), st.integers(0, 3),
       st.lists(st.booleans(), min_size=16, max_size=16))
def test_fuzz_service_never_serves_infeasible(service, qseed, variant,
                                              free_bits):
    """Repeats, drifted targets and drifted engine signatures drive the
    warm/rebase/swarm tiers; whatever tier answers, a found mapping must
    be feasible against the actual problem."""
    svc = service
    q, g0 = _planted(qseed)
    g = g0 if variant == 0 else graphs.embed_query_in_target(
        np.random.default_rng(9000 + 13 * qseed + variant), q, 12)
    sig = free_engine_signature(free_bits)
    r = svc.match(q, g, key=31 * qseed + variant,
                  workload_key=(f"wl{qseed}", sig))
    if r.found:
        _check_mapping(r.mapping, q, g)
    s = svc.stats
    assert s.found <= s.calls
    for tier in (s.tier0, s.tier1, s.tier2):
        assert 0 <= tier.hits <= max(tier.checked, tier.launches)


@fuzz_settings()
@given(st.integers(0, 5),
       st.lists(st.booleans(), min_size=16, max_size=16))
def test_fuzz_snapshot_roundtrip_mid_run(snap_service, seed, free_bits):
    """Snapshots taken mid-fuzz (the store growing across examples)
    restore bit for bit into a fresh twin service."""
    q, g = _planted(seed)
    snap_service.match(q, g, key=seed,
                       workload_key=(f"snap{seed}",
                                     free_engine_signature(free_bits)))
    assert snap_service.verify_snapshot_roundtrip()


# ---------------------------------------------------------------------------
# real matcher mode: the analytic accounting holds on live launches too
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_real_mode_invariants(seed):
    sc = build_scenario({
        "name": f"fuzz-real-{seed}", "seed": seed, "horizon": 0.12,
        "streams": [{
            "arrival": {"kind": "poisson", "rate_hz": 25},
            "workload": {"kind": "uniform", "complexity": "simple"},
            "urgency": {"kind": "bernoulli", "urgent_frac": 0.3},
        }],
    })
    cfg = SimConfig(platform=EDGE, matcher_mode="real", pso_cfg=FUZZ_CFG,
                    window_stages=2, validate=True, device="cpu")
    r = Simulator(cfg, get_scheduler("immsched")).run(sc)
    ms = r.matcher_stats
    assert r.alloc_conflicts == 0
    assert sum(ms[f"sched_tier{i}_decisions"] for i in range(3)) == \
        ms["sched_matcher_decisions"]
    assert ms["found"] <= ms["calls"]
    assert ms["tier2_launches"] > 0
