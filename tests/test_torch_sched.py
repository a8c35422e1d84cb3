"""The port's scheduler and simulator (``repro_torch.sched`` with
``accel/energy`` and ``core/{interrupts,ullmann,ilp}``) against the JAX
package's, on the CPU.

* Analytic mode is held bit for bit: the same scenario through the same
  scheduler gives the reference's ``SimResult`` field for field, its
  ``percentiles`` and ``matcher_stats`` included (minus wall clocks and
  the persistence counters; warm restarts are held in
  ``tests/test_torch_restart.py``).
* The scenario builders reproduce the reference's golden SHA-256 digests
  (imported from ``tests/test_scenario_registry.py``'s ``GOLDEN``).
* The host modules (interrupt policies, serial Ullmann, XY routes, the
  cost model) give the reference's values.

Real mode is in ``tests/test_torch_sched_real.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import sched as jsched
from repro.accel import platform as jplat
from repro.accel import energy as jenergy
from repro.core import ilp as jilp
from repro.core import interrupts as jinterrupts
from repro.core import pso as jpso
from repro.core import ullmann as jullmann
from repro.sched import metrics as jmetrics
from repro.sched import tasks as jtasks
from repro.workloads import zoo as jzoo
from repro_torch import sched as tsched
from repro_torch.accel import energy as tenergy
from repro_torch.accel import platform as tplat
from repro_torch.core import graphs as tgraphs
from repro_torch.core import ilp as tilp
from repro_torch.core import interrupts as tinterrupts
from repro_torch.core import pso as tpso
from repro_torch.core import ullmann as tullmann
from repro_torch.sched import metrics as tmetrics
from repro_torch.sched import tasks as ttasks
from repro_torch.workloads import zoo as tzoo
from test_scenario_registry import GOLDEN, scenario_digest
from test_torch_service import PERSISTENCE_KEYS

jax.config.update("jax_platform_name", "cpu")

SCHEDULERS = ["immsched", "isosched", "prema", "planaria", "moca", "cdmsa"]

#: scenarios, each built from a package's ``sched.tasks`` and
#: ``workloads.zoo``: the reference's ``tests/test_scale.py`` shapes, a
#: burst, a cold restart, a mixed burst with fragmentation churn and a
#: generator-backed stream
SCENARIOS = {
    "poisson": lambda tasks, zoo: tasks.make_scenario(
        "simple", rate_hz=40.0, horizon=1.0, seed=1),
    "burst": lambda tasks, zoo: tasks.make_burst_scenario(
        "simple", rate_hz=20.0, horizon=1.0, seed=2),
    "restart": lambda tasks, zoo: tasks.make_restart_scenario(seed=3),
    "fixed": lambda tasks, zoo: tasks.fixed_scenario(
        zoo.workload_complexity_class("simple")[:4]),
    "middle": lambda tasks, zoo: tasks.make_scenario(
        "middle", rate_hz=30, horizon=0.4, seed=5),
    "mixed-churn": lambda tasks, zoo: tasks.make_mixed_burst_scenario(
        "simple", "middle", rate_hz=25, horizon=0.3, burst_size=4,
        hard_frac=0.5, burst_frac=0.6, churn_rate_hz=50.0, seed=9),
    "streaming": lambda tasks, zoo: tasks.make_streaming_scenario(
        "simple", rate_hz=50.0, horizon=1.0, seed=7),
}


def _scenario(side, case):
    """The named scenario built by the reference's (``"jax"``) or the
    port's (``"torch"``) builders."""
    return SCENARIOS[case](*((jtasks, jzoo) if side == "jax"
                             else (ttasks, tzoo)))


def _cfgs(**kw):
    """Matching SimConfigs of both packages: EDGE, backend ``ref``, the
    port's service on the CPU."""
    pso_kw = kw.pop("pso", dict(num_particles=32, epochs=2, inner_steps=8))
    jcfg = jsched.SimConfig(platform=jplat.EDGE,
                            pso_cfg=jpso.PSOConfig(backend="ref", **pso_kw),
                            **kw)
    tcfg = tsched.SimConfig(platform=tplat.EDGE,
                            pso_cfg=tpso.PSOConfig(backend="ref", **pso_kw),
                            device="cpu", **kw)
    return jcfg, tcfg


def _comparable(result, skip=()):
    """A SimResult as a dict, without wall clocks, the persistence
    counters and the keys in ``skip``."""
    d = dataclasses.asdict(result)
    d["matcher_stats"] = {
        k: v for k, v in d["matcher_stats"].items()
        if not (k.endswith("wall_s") and k != "sched_prune_wall_s")
        and k != "fe_wait_s" and k not in PERSISTENCE_KEYS
        and k not in skip}
    return d


def _diff(a, b):
    return {k: (a[k], b[k]) for k in a if a[k] != b[k]}


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

_EXPLICIT = {
    "explicit-poisson-bursty": ("poisson-bursty", {
        "name": "middle-burst3", "seed": 7, "horizon": 0.3,
        "streams": [{
            "arrival": {"kind": "burst", "rate_hz": 30,
                        "burst_size": 3, "burst_frac": 0.4},
            "workload": {"kind": "uniform", "complexity": "middle"},
            "urgency": {"kind": "bernoulli", "urgent_frac": 0.2},
            "deadline": {"kind": "slack", "deadline_slack": 1.5,
                         "urgent_slack": 1.0, "base_exec_estimate": 5e-3},
        }]}),
    "explicit-mixed-churn": ("mixed-churn", {
        "name": "mixed-simple-middle-burst4", "seed": 9, "horizon": 0.3,
        "streams": [
            {"arrival": {"kind": "burst", "rate_hz": 25, "burst_size": 4,
                         "burst_frac": 0.6},
             "workload": {"kind": "mixed_burst", "easy": "simple",
                          "hard": "middle", "hard_frac": 0.5,
                          "burst_size": 4},
             "urgency": {"kind": "never"},
             "deadline": {"kind": "slack", "deadline_slack": 2.0,
                          "urgent_slack": 1.25, "base_exec_estimate": 5e-3}},
            {"arrival": {"kind": "poisson", "rate_hz": 50.0},
             "workload": {"kind": "uniform", "complexity": "simple"},
             "urgency": {"kind": "always"},
             "deadline": {"kind": "slack", "deadline_slack": 2.0,
                          "urgent_slack": 1.25,
                          "base_exec_estimate": 5e-3}}]}),
}

#: the port's builder for each GOLDEN case, with the reference test's args
_PORT_GOLDEN = {
    "poisson": lambda: ttasks.make_scenario(
        "simple", rate_hz=25, horizon=0.4, seed=3),
    "poisson-bursty": lambda: ttasks.make_scenario(
        "middle", rate_hz=30, horizon=0.3, urgent_frac=0.2,
        deadline_slack=1.5, urgent_slack=1.0, burst_size=3, burst_frac=0.4,
        seed=7),
    "burst": lambda: ttasks.make_burst_scenario(
        "simple", rate_hz=40, horizon=0.3, seed=11),
    "mixed": lambda: ttasks.make_mixed_burst_scenario(
        rate_hz=30, horizon=0.4, seed=5),
    "mixed-churn": lambda: ttasks.make_mixed_burst_scenario(
        "simple", "middle", rate_hz=25, horizon=0.3, burst_size=4,
        hard_frac=0.5, burst_frac=0.6, churn_rate_hz=50.0, seed=9),
    "restart": lambda: ttasks.make_restart_scenario(seed=3),
    "restart-knobs": lambda: ttasks.make_restart_scenario(
        "middle", rate_hz=25, phase_horizon=0.3, burst_size=3,
        burst_frac=0.5, urgent_frac=0.2, restart_gap=2e-3, seed=13),
    "streaming": lambda: ttasks.make_streaming_scenario(
        "simple", rate_hz=50, horizon=0.5, seed=2),
    "streaming-bursty": lambda: ttasks.make_streaming_scenario(
        "simple", rate_hz=40, horizon=0.4, burst_size=5, burst_frac=0.3,
        seed=21),
}


@pytest.mark.parametrize("case", sorted(_PORT_GOLDEN) + sorted(_EXPLICIT))
def test_port_scenarios_reproduce_the_golden_digests(case):
    if case in _EXPLICIT:
        golden, spec = _EXPLICIT[case]
        sc = tsched.build_scenario(spec)
    else:
        golden, sc = case, _PORT_GOLDEN[case]()
    assert set(_PORT_GOLDEN) == set(GOLDEN)
    assert scenario_digest(sc) == GOLDEN[golden][1]


def test_registry_pieces_are_the_reference_s():
    for name in ("ARRIVALS", "WORKLOADS", "URGENCY", "DEADLINES",
                 "RESTARTS"):
        assert getattr(tsched, name).names() == \
            getattr(jsched, name).names(), name
    spec = {"horizon": 0.2, "streams": [{
        "arrival": {"kind": "trace", "times": [0.0, 0.05, 0.5],
                    "counts": [1, 2, 1]},
        "workload": {"kind": "named", "name": "mobilenetv2"},
        "deadline": {"kind": "fixed", "offset": 1.0}}]}
    assert scenario_digest(tsched.build_scenario(spec)) == \
        scenario_digest(jsched.build_scenario(spec))


# ---------------------------------------------------------------------------
# analytic mode: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(SCENARIOS))
@pytest.mark.parametrize("name", SCHEDULERS)
def test_analytic_simresult_equals_jax_bitwise(name, case):
    jcfg, tcfg = _cfgs(validate=True)
    want = jsched.Simulator(jcfg, jsched.get_scheduler(name)).run(
        _scenario("jax", case))
    got = tsched.Simulator(tcfg, tsched.get_scheduler(name)).run(
        _scenario("torch", case))
    assert got.total > 0 and got.finished > 0 and not got.truncated
    assert not _diff(_comparable(got), _comparable(want))


@pytest.mark.parametrize("case", ["poisson", "burst", "restart", "fixed"])
@pytest.mark.parametrize("name", SCHEDULERS)
def test_heap_loop_bitwise_equal_legacy(name, case):
    _, tcfg = _cfgs()
    sc = _scenario("torch", case)
    a = tsched.Simulator(tcfg, tsched.get_scheduler(name)).run(sc)
    b = tsched.Simulator(tcfg, tsched.get_scheduler(name)).run_legacy(sc)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_metrics_equal_jax():
    names = ["immsched", "isosched", "prema", "planaria"]
    want = jmetrics.run_all(_scenario("jax", "middle"), jplat.EDGE, names)
    got = tmetrics.run_all(_scenario("torch", "middle"), tplat.EDGE, names,
                           device="cpu")
    assert tmetrics.speedup_table(got) == jmetrics.speedup_table(want)
    assert tmetrics.energy_efficiency(got) == \
        jmetrics.energy_efficiency(want)
    for fn in ("pipeline_tier_rates", "transfer_stats", "frontend_stats",
               "warm_restart_stats"):
        for name in names:
            assert getattr(tmetrics, fn)(got[name]) == \
                getattr(jmetrics, fn)(want[name]), (fn, name)
    assert set(tmetrics.matcher_service_stats(got)) == \
        set(jmetrics.matcher_service_stats(want))
    kw = dict(horizon=0.3, iters=3)
    assert tmetrics.latency_bound_throughput(
        "immsched", tplat.EDGE, "simple", device="cpu", **kw) == \
        jmetrics.latency_bound_throughput("immsched", jplat.EDGE, "simple",
                                          **kw)


def test_cost_model_equals_jax():
    jc, tc = jenergy.CostModel(jplat.CLOUD), tenergy.CostModel(tplat.CLOUD)
    kw = dict(num_particles=64, epochs=4, inner_steps=12)
    jp, tp = jpso.PSOConfig(**kw), tpso.PSOConfig(**kw)
    for wl in ("unet", "resnet50", "qwen-7b"):
        jw, tw = jzoo.get_workload(wl), tzoo.get_workload(wl)
        for eng in (1, 7, 128):
            assert tc.exec_tss(tw, eng) == jc.exec_tss(jw, eng)
            assert tc.exec_lts(tw, eng, 0.3) == jc.exec_lts(jw, eng, 0.3)
    for n, m in ((8, 96), (56, 144)):
        assert tc.sched_immsched(n, m, tp, 32) == \
            jc.sched_immsched(n, m, jp, 32)
        assert tc.sched_immsched_prune(n, m, 4, 3) == \
            jc.sched_immsched_prune(n, m, 4, 3)
        assert tc.sched_immsched_revalidate(n, m, 4, 5) == \
            jc.sched_immsched_revalidate(n, m, 4, 5)
    assert tc.sched_serial_cpu(1e9, 70) == jc.sched_serial_cpu(1e9, 70)
    assert tc.sched_lts_heuristic(9) == jc.sched_lts_heuristic(9)
    assert tc.preemption_cost_tss(3e5) == jc.preemption_cost_tss(3e5)
    assert tc.preemption_cost_lts(3e5) == jc.preemption_cost_lts(3e5)


# ---------------------------------------------------------------------------
# host modules: interrupts, serial Ullmann, ILP
# ---------------------------------------------------------------------------

def test_interrupt_policies_equal_jax():
    rng = np.random.default_rng(0)
    for trial in range(20):
        k = int(rng.integers(1, 7))
        rows = [(i, int(rng.integers(1, 4)), [2 * i, 2 * i + 1],
                 float(rng.random()), float(rng.random() * 3))
                for i in range(k)]
        idle = [int(e) for e in rng.choice(np.arange(20, 40),
                                           int(rng.integers(0, 4)),
                                           replace=False)]
        need = int(rng.integers(1, 2 * k + 4))
        now = float(rng.random())
        decs = [mod.select_victims(
            [mod.RunningTask(i, p, list(e), remaining_time=r, deadline=d)
             for i, p, e, r, d in rows], list(idle), need, 2, now)
            for mod in (tinterrupts, jinterrupts)]
        assert dataclasses.asdict(decs[0]) == dataclasses.asdict(decs[1])
        exec_t, win = float(rng.random()), float(rng.random() - 0.1)
        assert tinterrupts.adaptive_preemption_ratio(exec_t, win) == \
            jinterrupts.adaptive_preemption_ratio(exec_t, win)
        ratio = float(rng.random())
        assert tinterrupts.engines_needed_for(need, 64, ratio) == \
            jinterrupts.engines_needed_for(need, 64, ratio)


@pytest.mark.parametrize("seed", range(4))
def test_serial_ullmann_equals_jax(seed):
    rng = np.random.default_rng(seed)
    q = tgraphs.random_dag(rng, 5, 0.4)
    g = tgraphs.embed_query_in_target(rng, q, 9)
    mask = tgraphs.compatibility_mask(q, g)
    ts, js = tullmann.SerialStats(), jullmann.SerialStats()
    got = tullmann.serial_ullmann(q.adj, g.adj, mask, 3, ts)
    want = jullmann.serial_ullmann(q.adj, g.adj, mask, 3, js)
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert tullmann.count_monomorphisms(q.adj, g.adj, mask) == \
        jullmann.count_monomorphisms(q.adj, g.adj, mask)


def test_xy_route_equals_jax():
    for tp, jp in ((tplat.EDGE, jplat.EDGE), (tplat.CLOUD, jplat.CLOUD)):
        for src in range(tp.engines):
            for dst in range(0, tp.engines, 7):
                assert tilp.xy_route(tp, src, dst) == \
                    jilp.xy_route(jp, src, dst)
    r = tilp.xy_route(tplat.EDGE, 0, tplat.EDGE.engines - 1)
    assert len(r) == (tplat.EDGE.noc_rows - 1) + (tplat.EDGE.noc_cols - 1)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

def test_persistence_is_refused(monkeypatch, tmp_path):
    """A service without a persist dir refuses snapshots: ``save_snapshot``
    and ``restore_snapshot`` raise, and ``persist_dir=False`` keeps
    persistence off even under ``REPRO_PERSIST_DIR`` (warm restarts are
    in ``tests/test_torch_restart.py``)."""
    from repro_torch.core.service import MatcherService
    monkeypatch.setenv("REPRO_PERSIST_DIR", str(tmp_path))
    svc = MatcherService(tpso.PSOConfig(), device="cpu", persist_dir=False)
    assert svc.persist_dir is None
    with pytest.raises(RuntimeError, match="persist"):
        svc.save_snapshot()
    with pytest.raises(RuntimeError, match="persist"):
        svc.restore_snapshot()
    assert not list(tmp_path.iterdir())


def test_default_restart_is_cold():
    """The simulator's default has no persist dir: IMMSched's service has
    no snapshot store, and a restart saves and restores nothing."""
    cfg = tsched.SimConfig(platform=tplat.EDGE, device="cpu")
    assert cfg.persist_dir is None
    sched = tsched.get_scheduler("immsched")
    res = tsched.Simulator(cfg, sched).run(
        ttasks.make_restart_scenario(seed=3))
    assert sched._service.persist_dir is None
    stats = res.matcher_stats
    assert stats["restart_count"] >= 1
    assert stats["restart_snapshots_saved"] == 0
    assert stats["restart_boot_restores"] == 0
    assert stats["restart_restored_state_sigs"] == 0
    assert stats["snapshot_saves"] == 0 and stats["snapshot_restores"] == 0
