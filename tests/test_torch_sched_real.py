"""The port's scheduler in real mode against the JAX package's, on the
CPU: IMMSched's decisions through the port's ``MatcherService`` and
IsoSched's through the port's serial Ullmann, plus the ILP schedule of a
port match.

Real mode is held on outcomes, as ROADMAP's parity contract asks of whole
runs: the port's service draws what the reference's request key
``PRNGKey(0)`` draws (injected from the test side, since the scheduler
passes no keys), and every mapping it serves must pass the JAX
``ref.is_feasible``. IsoSched's host search is the same numpy on both
sides, so its runs are held bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import sched as jsched
from repro.accel import platform as jplat
from repro.core import ilp as jilp
from repro.core import preemptible_dag as jpd
from repro.core import service as jservice
from repro.sched import tasks as jtasks
from repro.workloads import zoo as jzoo
from repro_torch import sched as tsched
from repro_torch.accel import platform as tplat
from repro_torch.accel import target_graph as ttg
from repro_torch.core import ilp as tilp
from repro_torch.core import preemptible_dag as tpd
from repro_torch.core import pso as tpso
from repro_torch.core.matcher import IMMSchedMatcher
from repro_torch.core.service import MatcherService, shape_bucket
from repro_torch.sched import tasks as ttasks
from repro_torch.workloads import zoo as tzoo
from test_torch_sched import _cfgs, _comparable, _diff
from test_torch_service import _check_mapping, _jax_stream

jax.config.update("jax_platform_name", "cpu")

#: keys the reference's and the port's drains count differently by
#: design: the port fetches the swarm's early-exit bool each epoch (the
#: reference decides it on the device) and donates only its revalidation
#: launches
TRANSFER_KEYS = {"host_syncs", "host_syncs_per_drain", "donated_launches"}


@pytest.mark.parametrize("name,window", [("mobilenetv2", 2),
                                         ("resnet50", 4)])
def test_ilp_tensors_valid_for_port_match(name, window):
    """The reference's ``test_ilp_tensors_valid_for_real_match`` on a
    port match, drawn from the reference's ``PRNGKey(0)``: the schedule
    tensors validate and equal the reference's for the same mapping."""
    cap = tplat.EDGE.engine_tile_capacity_macs()
    pd = tpd.build_preemptible_dag([(0, tzoo.get_workload(name), 0)],
                                   tile_capacity_macs=cap,
                                   window_stages=window)
    jpdag = jpd.build_preemptible_dag([(0, jzoo.get_workload(name), 0)],
                                      tile_capacity_macs=cap,
                                      window_stages=window)
    tgt = ttg.free_engine_graph(tplat.EDGE, [True] * tplat.EDGE.engines)
    cfg = tpso.PSOConfig(num_particles=48, epochs=4, inner_steps=10,
                         backend="ref")
    res = IMMSchedMatcher(cfg, device="cpu").match(
        pd.graph, tgt, stream=_jax_stream(0, (pd.n, tgt.n), cfg))
    assert res.found
    st = tilp.build_schedule_tensors(pd, np.asarray(res.mapping), tplat.EDGE)
    assert tilp.validate_schedule(st, pd) == []
    assert st.X.sum() == pd.n
    want = jilp.build_schedule_tensors(jpdag, np.asarray(res.mapping),
                                       jplat.EDGE)
    np.testing.assert_array_equal(st.X, want.X)
    np.testing.assert_array_equal(st.Y, want.Y)
    assert (st.task_ids, st.link_ids) == (want.task_ids, want.link_ids)
    assert jilp.validate_schedule(want, jpdag) == []


# ---------------------------------------------------------------------------
# real mode: outcomes
# ---------------------------------------------------------------------------

def _record(monkeypatch, cls, served, keys_of=None):
    """Wrap ``cls.match_many`` to record ``(problem, result)`` pairs;
    ``keys_of(service, problems)`` supplies the request keys the
    scheduler leaves out."""
    orig = cls.match_many

    def match_many(self, problems, keys=None, workload_keys=None,
                   engine_sigs=None):
        assert keys is None, "the scheduler passes no keys"
        if keys_of is not None:
            keys = keys_of(self, problems)
        res = orig(self, problems, keys=keys, workload_keys=workload_keys,
                   engine_sigs=engine_sigs)
        served.extend(zip(problems, res))
        return res
    monkeypatch.setattr(cls, "match_many", match_many)


def _reference_keys(svc, problems):
    """The port's draw streams of the reference's key ``PRNGKey(0)``."""
    return [_jax_stream(0, shape_bucket(q.n, g.n, svc.n_multiple,
                                        svc.m_multiple), svc.cfg)
            for q, g in problems]


#: real-mode cases: (scenario from a package's ``sched.tasks`` and
#: ``workloads.zoo``, swarm); the reference tests' fixed scenario and urgent
#: burst, and a cold restart (the service boots anew mid-run)
REAL = {
    "fixed": (lambda tasks, zoo: tasks.fixed_scenario(
        [zoo.get_workload(n) for n in ("unet", "resnet50", "unet",
                                       "mobilenetv2")], urgent_last=True),
        dict(num_particles=32, epochs=2, inner_steps=6)),
    "burst": (lambda tasks, zoo: tasks.make_burst_scenario(
        "simple", rate_hz=30, horizon=0.25, burst_size=3, burst_frac=0.8,
        urgent_frac=0.7, seed=5),
        dict(num_particles=32, epochs=2, inner_steps=6)),
    "restart": (lambda tasks, zoo: tasks.make_restart_scenario(
        rate_hz=20, phase_horizon=0.15, burst_size=3, burst_frac=0.6,
        urgent_frac=0.6, seed=3),
        dict(num_particles=16, epochs=2, inner_steps=4)),
}


@pytest.mark.parametrize("case", sorted(REAL))
def test_real_mode_outcomes_equal_jax(monkeypatch, case):
    """IMMSched in real mode, EDGE, window_stages=2, backend ``ref``: the
    port's service on the reference's draws gives the reference's
    outcomes, and every mapping it serves is feasible."""
    jserved, tserved = [], []
    _record(monkeypatch, jservice.MatcherService, jserved)
    _record(monkeypatch, MatcherService, tserved, _reference_keys)
    scenario, swarm = REAL[case]
    jcfg, tcfg = _cfgs(matcher_mode="real", window_stages=2, validate=True,
                       pso=swarm)
    want = jsched.Simulator(jcfg, jsched.get_scheduler("immsched")).run(
        scenario(jtasks, jzoo))
    sc = scenario(ttasks, tzoo)
    got = tsched.Simulator(tcfg, tsched.get_scheduler("immsched")).run(sc)
    assert got.finished == got.total
    ms = got.matcher_stats
    assert ms["tier2_launches"] > 0 and ms["found"] > 0
    assert ms["restart_count"] == len(sc.restarts)
    # finished, urgent_met, deadline_met, the tier decisions, the service's
    # tier counters and found counts, and the charged latencies
    assert not _diff(_comparable(got, TRANSFER_KEYS),
                     _comparable(want, TRANSFER_KEYS))
    assert [(r.tier, r.found) for _, r in tserved] == \
        [(r.tier, r.found) for _, r in jserved]
    for (q, g), r in tserved:
        if r.found:
            _check_mapping(r.mapping, q, g)


@pytest.mark.parametrize("window", [2, 4])
def test_isosched_real_mode_equals_jax_bitwise(window):
    """IsoSched's serial host Ullmann is the same numpy on both sides."""
    jcfg, tcfg = _cfgs(matcher_mode="real", window_stages=window,
                       validate=True)
    scenario, _ = REAL["fixed"]
    want = jsched.Simulator(jcfg, jsched.get_scheduler("isosched")).run(
        scenario(jtasks, jzoo))
    got = tsched.Simulator(tcfg, tsched.get_scheduler("isosched")).run(
        scenario(ttasks, tzoo))
    assert got.matcher_stats["memo_misses"] > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
