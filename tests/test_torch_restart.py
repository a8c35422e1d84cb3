"""The port's warm-restart persistence (``repro_torch.core.persist``,
``repro_torch.checkpoint.manager``, ``MatcherService`` snapshots and the
scheduler's warm restarts) on the CPU, at the small shapes of
``tests/test_restart.py``, and against the JAX package.

* The reference tests' cases, ported, except the five of its executable
  cache, which has no counterpart: the restored burst served at Tier 0
  with one host sync covers what they guarded (a restarted service's
  first burst served warm).
* The codecs give the JAX codecs' outputs; a checkpoint written by one
  package's ``CheckpointManager`` is read by the other's; one store gives
  the same snapshot from both services, key for key and leaf for leaf.
* The simulator's warm restarts: analytic mode bit for bit against
  ``repro.sched`` (``SimResult`` and ``warm_restart_stats``), real mode
  on outcomes with the reference's draws injected, as
  ``tests/test_torch_sched_real.py`` does.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core import graphs as jgraphs
from repro.core import persist as jpersist
from repro.core import pso as jpso
from repro.core import service as jservice
from repro.kernels import backend as jbackend
from repro.sched import metrics as jmetrics
from repro.sched import tasks as jtasks
from repro.workloads import zoo as jzoo
from repro_torch.accel.platform import EDGE
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import graphs, persist, pso
from repro_torch.core.service import MatcherService, store_state_from_numpy
from repro_torch.kernels import backend as kernel_backend
from repro_torch.sched import SimConfig, Simulator, get_scheduler
from repro_torch.sched import tasks as ttasks
from repro_torch.sched.metrics import warm_restart_stats
from repro_torch.sched.tasks import make_restart_scenario, make_scenario
from repro_torch.workloads import zoo as tzoo
from test_torch_sched import _cfgs, _comparable, _diff
from test_torch_sched_real import REAL, TRANSFER_KEYS, _record, \
    _reference_keys
from test_torch_service import _check_mapping

jax.config.update("jax_platform_name", "cpu")

CFG = pso.PSOConfig(num_particles=8, epochs=2, inner_steps=4)
#: the reference's keys of tests/test_restart.py, and the scheduler's
#: (name, engine-signature) workload keys
KEYS = [
    ("wl/1", 8, 16, "abcd"),
    (("mobilenetv2", b"\x01\x02\xff"), 8, 16, "ff" * 20),
    ("plain", None, 1.5, True),
    ("digest", (8, 16), b""),
    (("a", (1, (b"\x00", None))), -3, 0.0, False),
]


@pytest.fixture
def no_jax_cache(monkeypatch):
    """A JAX service with a persist dir otherwise points JAX's
    process-wide compilation cache at it, and exports executables."""
    monkeypatch.setenv("REPRO_JAX_CACHE", "0")
    monkeypatch.setenv("REPRO_AOT_CACHE", "0")


def _svc(tmp=None, cfg=CFG, **kw):
    return MatcherService(cfg, device="cpu",
                          persist_dir=str(tmp) if tmp else None, **kw)


def _planted(seed, n=6, m=12, edge_prob=0.35):
    rng = np.random.default_rng(seed)
    q = graphs.random_dag(rng, n, edge_prob)
    return q, graphs.embed_query_in_target(rng, q, m)


def _warm_service(tmp, seeds=(1, 2, 3)):
    """A service that has served a burst cold and again warm, so every
    problem has a stored carry."""
    svc = _svc(tmp)
    probs = [_planted(s) for s in seeds]
    wks = [f"wl/{s}" for s in seeds]
    cold = svc.match_many(probs, workload_keys=wks)
    warm = svc.match_many(probs, workload_keys=wks)
    return svc, probs, wks, cold, warm


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def test_key_codec_roundtrip():
    for k in KEYS:
        assert persist.decode_key(persist.encode_key(k)) == k


def test_key_codec_rejects_unencodable():
    with pytest.raises(TypeError):
        persist.encode_key((object(),))


@pytest.mark.parametrize("key", KEYS)
def test_key_codec_gives_the_jax_codec_s_json(key):
    """The same JSON, with bytes signatures and nested tuples, both ways."""
    enc = persist.encode_key(key)
    assert json.dumps(enc) == json.dumps(jpersist.encode_key(key))
    assert jpersist.decode_key(json.loads(json.dumps(enc))) == key
    assert persist.decode_key(json.loads(json.dumps(
        jpersist.encode_key(key)))) == key


def test_carry_leaves_roundtrip():
    rng = np.random.default_rng(0)
    carries = [(rng.random((4, 8), dtype=np.float32),
                np.float32(i), rng.random((4, 8), dtype=np.float32))
               for i in range(3)]
    leaves = persist.carry_leaves("x", carries)
    back = persist.carries_from_leaves("x", leaves, 3)
    for a, b in zip(carries, back):
        for u, v in zip(a, b):
            assert np.array_equal(np.asarray(u), np.asarray(v))


def test_carry_leaves_give_the_jax_leaves():
    """Tensors (the port's carries) and arrays (the reference's) flatten
    to the same leaf names, dtypes, shapes and bytes."""
    rng = np.random.default_rng(1)
    carries = [(rng.random((5, 9), dtype=np.float32),
                np.float32(-i - 0.5), rng.random((5, 9), dtype=np.float32))
               for i in range(4)]
    want = jpersist.carry_leaves("exact", carries)
    got = persist.carry_leaves("exact", [tuple(torch.from_numpy(
        np.asarray(x)) for x in c) for c in carries])
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        assert got[k].tobytes() == w.tobytes(), k


def test_config_digest_sensitivity():
    d0 = kernel_backend.config_digest(CFG)
    assert d0 == kernel_backend.config_digest(
        pso.PSOConfig(num_particles=8, epochs=2, inner_steps=4))
    assert d0 != kernel_backend.config_digest(CFG.replace(epochs=3))
    assert d0 != kernel_backend.config_digest(CFG.replace(backend="ref"))
    assert d0 != kernel_backend.config_digest(CFG, extra=("x",))


def test_config_digest_is_the_jax_digest():
    """The same suite name, fields and extras hash alike in both
    packages (the port's ``PSOConfig`` has the reference's fields); the
    suite name is part of the digest."""
    jcfg = jpso.PSOConfig(num_particles=8, epochs=2, inner_steps=4,
                          backend="ref")
    cfg = pso.PSOConfig.from_dict(dataclasses.asdict(jcfg))
    assert kernel_backend.config_digest(cfg, extra=("e", 1)) == \
        jbackend.config_digest(jcfg, extra=("e", 1))
    assert kernel_backend.config_digest(cfg.replace(backend="cuda")) != \
        jbackend.config_digest(jcfg)


# ---------------------------------------------------------------------------
# snapshot round trips
# ---------------------------------------------------------------------------

def test_snapshot_roundtrip_bitwise_identical(tmp_path):
    svc1, probs, wks, _, warm = _warm_service(tmp_path)
    step = svc1.save_snapshot(extra={"who": "test"})
    assert step == 0 and svc1.stats.snapshot_saves == 1

    svc2 = _svc(tmp_path)
    extra = svc2.restore_snapshot()
    assert extra == {"who": "test"}
    assert svc2.stats.restored_carries == len(probs)
    again = svc2.match_many(probs, workload_keys=wks)
    for a, b in zip(warm, again):
        assert a.found == b.found
        if a.found:
            assert np.array_equal(np.asarray(a.mapping),
                                  np.asarray(b.mapping))
    # every found problem was served without a swarm epoch
    assert all(r.tier <= 1 for r in again if r.found)


def test_restored_burst_serves_tier0_with_one_host_sync(tmp_path):
    """What the reference's executable-cache tests guard: a restarted
    service's first burst is served warm. Here every request of the
    burst at Tier 0, in one drain with one host sync, with the mappings
    served before the restart."""
    svc1, probs, wks, _, warm = _warm_service(tmp_path, seeds=(1, 2, 3, 4))
    assert all(r.tier == 0 and r.found for r in warm)
    svc1.save_snapshot()
    svc2 = _svc(tmp_path)
    assert svc2.restore_snapshot() == {}
    again = svc2.match_many(probs, workload_keys=wks)
    assert [r.tier for r in again] == [0] * len(probs)
    assert svc2.stats.host_syncs == 1 and svc2.stats.drains == 1
    assert svc2.stats.tier2.launches == 0
    for (q, g), a, b in zip(probs, warm, again):
        assert np.array_equal(a.mapping, b.mapping)
        _check_mapping(b.mapping, q, g)


def test_snapshot_preserves_lru_recency(tmp_path):
    svc = _svc(tmp_path, warm_capacity=8)
    for s in (1, 2, 3, 4):
        q, g = _planted(s)
        svc.match(q, g, workload_key=f"wl/{s}")
    exact_before, _ = svc._carries.export_state()
    svc.save_snapshot()

    svc2 = _svc(tmp_path, warm_capacity=8)
    assert svc2.restore_snapshot() == {}
    exact_after, _ = svc2._carries.export_state()
    assert [k for k, _ in exact_before] == [k for k, _ in exact_after]


def test_stale_digest_snapshot_rejected_cleanly(tmp_path):
    svc1, *_ = _warm_service(tmp_path)
    svc1.save_snapshot()
    drifted = _svc(tmp_path, cfg=CFG.replace(epochs=3))
    assert drifted.restore_snapshot() is None
    assert drifted.stats.snapshot_stale_skipped == 1
    assert drifted.stats.restored_carries == 0
    assert len(drifted._carries) == 0


def test_future_format_version_rejected(tmp_path):
    svc1, *_ = _warm_service(tmp_path)
    svc1.save_snapshot()
    ckpt_dir = os.path.join(str(tmp_path), "snapshots", "step_000000000")
    with open(os.path.join(ckpt_dir, "extras.json")) as f:
        extras = json.load(f)
    extras["format_version"] = persist.SNAPSHOT_VERSION + 1
    with open(os.path.join(ckpt_dir, "extras.json"), "w") as f:
        json.dump(extras, f)
    svc2 = _svc(tmp_path)
    assert svc2.restore_snapshot() is None
    assert svc2.stats.snapshot_stale_skipped == 1


def test_empty_store_snapshot_roundtrip(tmp_path):
    svc = _svc(tmp_path)
    svc.save_snapshot(extra={"empty": True})
    svc2 = _svc(tmp_path)
    assert svc2.restore_snapshot() == {"empty": True}
    assert svc2.stats.restored_carries == 0


def test_restore_with_no_snapshot_is_none(tmp_path):
    svc = _svc(tmp_path)
    assert svc.restore_snapshot() is None
    assert svc.stats.snapshot_stale_skipped == 0


def test_snapshot_requires_persist_dir():
    svc = MatcherService(CFG, device="cpu", persist_dir=False)
    with pytest.raises(RuntimeError):
        svc.save_snapshot()
    with pytest.raises(RuntimeError):
        svc.restore_snapshot()


def test_persist_dir_false_overrides_env(tmp_path, monkeypatch):
    """persist_dir=False forces persistence off even under
    REPRO_PERSIST_DIR, as cold-restart baselines need."""
    monkeypatch.setenv(persist.ENV_PERSIST_DIR, str(tmp_path))
    off = MatcherService(CFG, device="cpu", persist_dir=False)
    assert off.persist_dir is None and off._ckpt is None
    via_env = MatcherService(CFG, device="cpu")
    assert via_env.persist_dir == str(tmp_path)


def test_scheduler_workload_keys_with_bytes_sig_snapshot(tmp_path):
    """The scheduler keys warm entries by (name, engine-signature bytes);
    those keys survive the JSON codec, in both stores."""
    svc = _svc(tmp_path)
    q, g = _planted(5)
    sig = b"\xf0\x0d"
    svc.match(q, g, workload_key=("wl", sig), engine_sig=sig)
    svc.save_snapshot()
    svc2 = _svc(tmp_path)
    svc2.restore_snapshot()
    assert svc2.stats.restored_carries == 1
    assert svc2.stats.restored_sim_entries == svc._carries.sim_entries
    r = svc2.match(q, g, workload_key=("wl", sig), engine_sig=sig)
    assert r.warm_hit


def test_verify_snapshot_roundtrip_and_snapshot_keep(tmp_path):
    svc, *_ = _warm_service(tmp_path)
    svc._ckpt.keep = 2
    for _ in range(3):
        assert svc.verify_snapshot_roundtrip()
    assert svc._ckpt.all_steps() == [1, 2]
    assert svc.stats.snapshot_saves == 3
    d = svc.stats_dict()
    assert d["snapshot_saves"] == 3 and d["aot_cache_hits"] == 0


# ---------------------------------------------------------------------------
# one store, the same snapshot from both packages
# ---------------------------------------------------------------------------

def test_same_store_gives_the_same_snapshot_from_both_packages(
        tmp_path, no_jax_cache):
    """The JAX service warm-started on planted problems, its
    ``export_state`` imported into the port's service through
    ``store_state_from_numpy``; both snapshots hold the same keys in LRU
    order (exact and similarity), the same leaf names and every leaf bit
    for bit. The port's snapshot then restores and serves the burst at
    Tier 0 with the reference's mappings."""
    jcfg = jpso.PSOConfig(num_particles=8, epochs=2, inner_steps=4,
                          backend="ref")
    jsvc = jservice.MatcherService(jcfg, persist_dir=str(tmp_path / "jax"),
                                   donate_buffers=False)
    seeds = (1, 2, 3)
    probs = [_planted(s) for s in seeds]
    jprobs = [tuple(jgraphs.Graph(adj=g.adj, types=g.types,
                                  weights=g.weights) for g in p)
              for p in probs]
    sigs = [bytes([s, 0xf0]) for s in seeds]
    wks = [("wl", sig) for sig in sigs]
    jsvc.match_many(jprobs, workload_keys=wks, engine_sigs=sigs)
    jwarm = jsvc.match_many(jprobs, workload_keys=wks, engine_sigs=sigs)
    exact, sim = jsvc._carries.export_state()
    assert exact and sim

    def host(items):
        return [(k, tuple(np.asarray(x) for x in jsvc._carry_tuple(c)))
                for k, c in items]
    svc = MatcherService(pso.PSOConfig.from_dict(dataclasses.asdict(jcfg)),
                         device="cpu", persist_dir=str(tmp_path / "torch"))
    svc.import_state(*store_state_from_numpy(host(exact), host(sim),
                                             device="cpu"))
    jsvc.save_snapshot()
    svc.save_snapshot()
    want, wx = JCheckpointManager(str(tmp_path / "jax" / "snapshots"),
                                  async_save=False).restore_flat()
    got, gx = CheckpointManager(str(tmp_path / "torch" / "snapshots"),
                                async_save=False).restore_flat()
    for k in ("exact_keys", "sim_keys", "format_version"):
        assert gx[k] == wx[k], k
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape
        assert got[name].tobytes() == w.tobytes(), name

    svc2 = MatcherService(svc.cfg, device="cpu",
                          persist_dir=str(tmp_path / "torch"))
    assert svc2.restore_snapshot() == {}
    again = svc2.match_many(probs, workload_keys=wks, engine_sigs=sigs)
    for (q, g), a, b in zip(probs, jwarm, again):
        assert (b.tier, b.found) == (a.tier, a.found) == (0, True)
        assert np.array_equal(np.asarray(a.mapping), b.mapping)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def test_restore_flat_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    arrays = {"a.0.S": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.int32(7)}
    mgr.save(3, arrays, extras={"meta": 1})
    back, extras = mgr.restore_flat()
    assert extras == {"meta": 1}
    assert set(back) == set(arrays)
    assert np.array_equal(back["a.0.S"], arrays["a.0.S"])
    assert back["b"] == 7


def test_restore_flat_empty_store(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    arrays, extras = mgr.restore_flat()
    assert arrays is None and extras is None


def test_restore_flat_rejects_nested(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"outer": {"inner": np.zeros(2)}})
    with pytest.raises(ValueError):
        mgr.restore_flat()


def test_async_save_commits_atomically_and_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True, keep=2)
    for step in range(4):
        mgr.save(step, {"x": torch.full((3,), float(step))},
                 extras={"step": step})
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    os.makedirs(os.path.join(str(tmp_path), "step_000000009.tmp"))
    assert mgr.latest_step() == 3            # a partial write is invisible
    back, extras = mgr.restore_flat()
    assert extras == {"step": 3} and back["x"].tolist() == [3.0] * 3


def test_jax_checkpoint_read_by_the_port(tmp_path):
    arrays = {"exact.00000.S": np.arange(6, dtype=np.float32).reshape(2, 3),
              "exact.00000.f": np.float32(-1.5),
              "snapshot.marker": np.zeros((), np.int8), "b": np.int32(7)}
    JCheckpointManager(str(tmp_path), async_save=False).save(
        5, arrays, extras={"meta": [1, "x"]})
    back, extras = CheckpointManager(str(tmp_path)).restore_flat()
    assert extras == {"meta": [1, "x"]}
    assert list(back) == sorted(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == np.shape(v)
        assert back[k].tobytes() == np.asarray(v).tobytes()


def test_port_checkpoint_read_by_jax(tmp_path):
    """A flat dict of tensors and arrays through ``restore_flat``, and a
    nested one through the reference's ``restore(state_like)``: the same
    leaf files and paths."""
    flat = {"S": torch.arange(6, dtype=torch.float32).view(2, 3),
            "n": np.int64(4), "mask": torch.tensor([True, False])}
    CheckpointManager(str(tmp_path / "flat"), async_save=False).save(
        1, flat, extras={"k": "v"})
    back, extras = JCheckpointManager(str(tmp_path / "flat")).restore_flat()
    assert extras == {"k": "v"}
    for k, v in flat.items():
        want = v.numpy() if torch.is_tensor(v) else np.asarray(v)
        assert back[k].dtype == want.dtype
        assert back[k].tobytes() == want.tobytes()
    nested = {"params": {"w": torch.ones(2, 2), "b": torch.zeros(2)},
              "opt": [torch.tensor(3.0), {"m": np.arange(3)}]}
    CheckpointManager(str(tmp_path / "nested"), async_save=False).save(
        2, nested)
    like = {"params": {"w": np.zeros((2, 2), np.float32),
                       "b": np.zeros(2, np.float32)},
            "opt": [np.zeros((), np.float32), {"m": np.zeros(3, np.int64)}]}
    state, _ = JCheckpointManager(str(tmp_path / "nested")).restore(like)
    assert np.array_equal(state["params"]["w"], np.ones((2, 2)))
    assert np.array_equal(state["opt"][1]["m"], np.arange(3))
    assert float(state["opt"][0]) == 3.0


# ---------------------------------------------------------------------------
# simulator restart events
# ---------------------------------------------------------------------------

def _restart_sc():
    return make_restart_scenario("simple", rate_hz=30, phase_horizon=0.2,
                                 seed=3)


def test_restart_scenario_shape():
    sc = _restart_sc()
    assert sc.restarts and sc.restarts[0] > 0.2
    base = make_scenario("simple", rate_hz=30, horizon=0.2,
                         burst_size=4, burst_frac=0.6, seed=3)
    assert len(sc.tasks) == 2 * len(base.tasks)
    names = [t.name for t in sc.tasks]
    assert names[:len(base.tasks)] == names[len(base.tasks):]


def test_sim_restart_cold_clears_predictor_state():
    r = Simulator(SimConfig(platform=EDGE, device="cpu"),
                  get_scheduler("immsched")).run(_restart_sc())
    st = warm_restart_stats(r)
    assert st["restart_count"] == 1
    assert st["restart_snapshots_saved"] == 0
    assert st["snapshot_restores"] == 0
    assert r.finished == r.total


def test_sim_restart_warm_restores_predictor_state(tmp_path):
    cfg = SimConfig(platform=EDGE, persist_dir=str(tmp_path), device="cpu")
    r = Simulator(cfg, get_scheduler("immsched")).run(_restart_sc())
    st = warm_restart_stats(r)
    assert st["restart_count"] == 1
    assert st["restart_snapshots_saved"] == 1
    assert st["snapshot_restores"] == 1
    assert st["restart_restored_state_sigs"] > 0
    assert r.finished == r.total


def test_sim_boot_restore_counted_separately_from_restart(tmp_path):
    """A second run over the same persist dir warm-boots from the first
    run's snapshot: that restore counts in ``restart_boot_restores``, not
    in the ``restart_restored_*`` counters."""
    cfg = SimConfig(platform=EDGE, persist_dir=str(tmp_path), device="cpu")
    r1 = Simulator(cfg, get_scheduler("immsched")).run(_restart_sc())
    assert warm_restart_stats(r1)["restart_boot_restores"] == 0
    r2 = Simulator(cfg, get_scheduler("immsched")).run(_restart_sc())
    st2 = warm_restart_stats(r2)
    assert st2["restart_boot_restores"] == 1
    assert st2["restart_count"] == 1
    assert st2["restart_restored_state_sigs"] > 0


def test_sim_restart_isosched_flushes_memo():
    r = Simulator(SimConfig(platform=EDGE, device="cpu"),
                  get_scheduler("isosched")).run(_restart_sc())
    assert r.matcher_stats["restart_count"] == 1
    assert r.finished == r.total


def test_sim_restart_real_mode_warm(tmp_path):
    cfg = SimConfig(platform=EDGE, matcher_mode="real", pso_cfg=CFG,
                    window_stages=2, persist_dir=str(tmp_path),
                    device="cpu")
    r = Simulator(cfg, get_scheduler("immsched")).run(_restart_sc())
    st = warm_restart_stats(r)
    assert st["restart_count"] == 1
    assert st["snapshot_restores"] == 1
    assert st["restart_restored_carries"] >= 0
    assert r.finished == r.total


@pytest.mark.parametrize("name", ["immsched", "isosched"])
def test_analytic_warm_restart_equals_jax_bitwise(tmp_path, no_jax_cache,
                                                  name):
    """The simple restart scenario, warm (a persist dir each), and a
    second run that warm-boots from the first's snapshot: ``SimResult``
    and ``warm_restart_stats`` bit for bit against ``repro.sched``."""
    jcfg, _ = _cfgs(persist_dir=str(tmp_path / "jax"))
    _, tcfg = _cfgs(persist_dir=str(tmp_path / "torch"))
    for _run in range(2):
        want = jsched.Simulator(jcfg, jsched.get_scheduler(name)).run(
            jtasks.make_restart_scenario("simple", rate_hz=30,
                                         phase_horizon=0.2, seed=3))
        got = Simulator(tcfg, get_scheduler(name)).run(_restart_sc())
        assert got.finished == got.total > 0
        assert not _diff(_comparable(got), _comparable(want))
        assert warm_restart_stats(got) == jmetrics.warm_restart_stats(want)


def test_real_mode_warm_restart_outcomes_equal_jax(tmp_path, monkeypatch,
                                                   no_jax_cache):
    """IMMSched in real mode over the restart scenario of
    ``tests/test_torch_sched_real.py``, warm: the port's service on the
    reference's draws gives the reference's outcomes (tiers, found,
    restored carries and posteriors), and every served mapping is
    feasible."""
    jserved, tserved = [], []
    _record(monkeypatch, jservice.MatcherService, jserved)
    _record(monkeypatch, MatcherService, tserved, _reference_keys)
    scenario, swarm = REAL["restart"]
    jcfg, _ = _cfgs(matcher_mode="real", window_stages=2, validate=True,
                    pso=swarm, persist_dir=str(tmp_path / "jax"))
    _, tcfg = _cfgs(matcher_mode="real", window_stages=2, validate=True,
                    pso=swarm, persist_dir=str(tmp_path / "torch"))
    want = jsched.Simulator(jcfg, jsched.get_scheduler("immsched")).run(
        scenario(jtasks, jzoo))
    got = Simulator(tcfg, get_scheduler("immsched")).run(
        scenario(ttasks, tzoo))
    assert got.finished == got.total
    st = warm_restart_stats(got)
    assert st["snapshot_restores"] == 1 and st["restart_snapshots_saved"] == 1
    assert st["restart_restored_state_sigs"] > 0
    assert st == jmetrics.warm_restart_stats(want)
    assert not _diff(_comparable(got, TRANSFER_KEYS),
                     _comparable(want, TRANSFER_KEYS))
    assert [(r.tier, r.found) for _, r in tserved] == \
        [(r.tier, r.found) for _, r in jserved]
    for (q, g), r in tserved:
        if r.found:
            _check_mapping(r.mapping, q, g)
