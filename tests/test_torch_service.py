"""The port's matcher service (``repro_torch.core.service``) on the CPU:
the carry store and the device carry pool, the drain arms and their
host-sync census, the async front end, and parity with the JAX package's
``MatcherService`` on the same planted problems and the same draws.

Parity is held on outcomes (tier, found, epochs_run per request, and
every served mapping feasible under the JAX ``ref.is_feasible``), as
ROADMAP's parity contract asks of whole runs. Tier-0 and Tier-1 decisions
are checked from carries both sides hold: the reference's store, exported
and imported into the port with ``store_state_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs
from repro.core import pso as jpso
from repro.core import service as jservice
from repro.kernels import ref as jref
from repro_torch.accel import platform as tplat
from repro_torch.accel import target_graph as ttg
from repro_torch.core import graphs, pso
from repro_torch.core import preemptible_dag as tpd
from repro_torch.core.matcher import IMMSchedMatcher
from repro_torch.core.service import (AsyncServiceFrontEnd, CarryStore,
                                      DeviceCarryPool, MatcherService,
                                      ServiceStats, shape_bucket,
                                      store_state_from_numpy)
from repro_torch.workloads import zoo
from test_torch_pso import _epoch_draws

jax.config.update("jax_platform_name", "cpu")

CFG = pso.PSOConfig(num_particles=24, epochs=3, inner_steps=8,
                    early_exit=True, backend="ref")
# two distinct shape buckets: (8, 16) and (8, 32)
BUCKET_ARGS = ((6, 12), (5, 24))
#: the reference's stats_dict keys of its persistence layer
PERSISTENCE_KEYS = [
    "aot_cache_hits", "aot_cache_misses", "aot_exports",
    "aot_export_failures", "aot_call_fallbacks", "snapshot_saves",
    "snapshot_restores", "snapshot_stale_skipped", "snapshot_skipped_keys",
    "restored_carries", "restored_sim_entries"]


def _svc(cfg=CFG, **kw):
    return MatcherService(cfg, device="cpu", **kw)


def _planted(seed, n, m, edge_prob=0.35):
    rng = np.random.default_rng(seed)
    q = graphs.random_dag(rng, n, edge_prob)
    return q, graphs.embed_query_in_target(rng, q, m)


def _jg(g):
    """The same graph as the JAX package's ``Graph``."""
    return jgraphs.Graph(adj=g.adj, types=g.types, weights=g.weights)


def _jax_stream(seed, bucket, cfg):
    """The port's draw stream of the draws the JAX service's request key
    ``PRNGKey(seed)`` gives at ``bucket``: epoch t uses split t."""
    keys = jax.random.split(jax.random.PRNGKey(seed), cfg.epochs)

    def draw(t):
        return {k: torch.from_numpy(np.array(v))
                for k, v in _epoch_draws(keys[t], cfg, *bucket).items()}
    return draw


def _burst(svc, specs, key=None):
    """Submit [(seed, n, m), ...] and drain; the request's seed is its
    draw stream unless ``key`` maps a spec to one."""
    for seed, n, m in specs:
        q, g = _planted(seed, n, m)
        svc.submit(q, g, key=seed if key is None else key(seed, n, m),
                   workload_key=(f"w{n}x{m}", seed))
    return svc.drain()


def _warm_specs(svc, per_bucket=2, max_seeds=6):
    """Specs across both buckets whose carries revalidate: cold-drains
    candidates and keeps the ones a repeat drain serves at Tier 0."""
    specs = []
    for n, m in BUCKET_ARGS:
        cands = [(s, n, m) for s in range(max_seeds)]
        _burst(svc, cands)
        warm = _burst(svc, cands)
        good = [c for c, r in zip(cands, warm) if r.tier == 0 and r.found]
        assert len(good) >= per_bucket, f"no warm problems for {(n, m)}"
        specs.extend(good[:per_bucket])
    return specs


def _fingerprint(r):
    return (None if r.mapping is None else np.asarray(r.mapping).tobytes(),
            r.found, r.tier, r.f_star, r.epochs_run)


def _check_mapping(mapping, q, g):
    assert mapping is not None
    assert bool(jref.is_feasible(jnp.asarray(mapping, jnp.uint8),
                                 jnp.asarray(q.adj), jnp.asarray(g.adj)))


def _sig(free):
    return ttg.free_engine_signature(np.asarray(free, bool))


# ---------------------------------------------------------------------------
# shape classes, stats
# ---------------------------------------------------------------------------

def test_shape_bucket_is_the_reference_s():
    for n in range(1, 40, 3):
        for m in range(n, 90, 7):
            for mult in ((8, 16), (4, 8)):
                assert shape_bucket(n, m, *mult) == \
                    jservice.shape_bucket(n, m, *mult)


def test_stats_dict_has_the_reference_keys_but_persistence():
    svc = _svc()
    _burst(svc, [(0, 6, 12)])
    want = set(jservice.MatcherService(
        jpso.PSOConfig(backend="ref"), donate_buffers=False,
        persist_dir=False).stats_dict())
    assert set(PERSISTENCE_KEYS) <= want
    # the persistence counters came with persistence: without a persist
    # dir they are all 0, the executable cache's always
    assert set(svc.stats_dict()) == want
    d = svc.stats_dict()
    assert all(d[k] == 0 for k in PERSISTENCE_KEYS)
    assert d["drains"] == 1 and d["host_syncs"] >= 1
    assert d["epoch_backend"] == "ref"


def test_service_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        MatcherService(CFG)
    assert _svc().device.type == "cpu"


# ---------------------------------------------------------------------------
# CarryStore
# ---------------------------------------------------------------------------

def test_carry_store_exact_lru_eviction_order():
    store = CarryStore(capacity=2, sim_capacity=4, stats=ServiceStats())
    store.put("a", 1)
    store.put("b", 2)
    store.get("a")                    # refresh a → b is now oldest
    store.put("c", 3)                 # evicts b
    assert store.get("a") == (1, True)
    assert store.get("b") == (None, False)
    assert store.get("c") == (3, True)
    assert store.stats.warm_evictions == 1


def test_carry_store_similarity_lru_eviction_order():
    stats = ServiceStats()
    store = CarryStore(capacity=4, sim_capacity=2, stats=stats)
    free = np.ones(16, bool)
    sigs = []
    for i in range(3):
        f = free.copy()
        f[i] = False
        sigs.append(_sig(f))
        store.put_similar("q", (8, 16), sigs[-1], carry=i)
    assert stats.sim_evictions == 1
    assert store.nearest("q", (8, 16), sigs[0]) is not None
    remaining = {s for (qd, bk, s) in store._sim}
    assert sigs[0] not in remaining and remaining == {sigs[1], sigs[2]}


def test_carry_store_nearest_picks_max_overlap():
    store = CarryStore(capacity=4, sim_capacity=8, stats=ServiceStats())
    base = np.zeros(16, bool)
    near = base.copy()
    near[:8] = True
    far = base.copy()
    far[12:14] = True
    store.put_similar("q", (8, 16), _sig(near), carry="near")
    store.put_similar("q", (8, 16), _sig(far), carry="far")
    query = base.copy()
    query[:6] = True                  # overlaps 'near' by 6, 'far' by 0
    got = store.nearest("q", (8, 16), _sig(query))
    assert got is not None and got[1] == "near"
    query2 = base.copy()
    query2[14:16] = True
    assert store.nearest("q", (8, 16), _sig(query2)) is None
    assert store.nearest("other", (8, 16), _sig(query)) is None
    assert store.nearest("q", (16, 32), _sig(query)) is None


def test_carry_store_index_matches_linear_scan_and_the_reference():
    """One sequence of puts, overwrites and probes on the port's store
    and the JAX package's: the popcount index, the linear scan and the
    reference give the same neighbour every time."""
    rng = np.random.default_rng(0)
    store = CarryStore(capacity=4, sim_capacity=256, stats=ServiceStats())
    jstore = jservice.CarryStore(capacity=4, sim_capacity=256,
                                 stats=jservice.ServiceStats())
    E = 32
    sigs = []

    def put(qd, sig, carry):
        store.put_similar(qd, (8, 16), sig, carry=carry)
        jstore.put_similar(qd, (8, 16), sig, carry=carry)

    for i in range(300):              # past capacity: evictions as well
        sig = _sig(rng.random(E) < rng.uniform(0.05, 0.95))
        put("q", sig, ("c", i))
        sigs.append(sig)
    for i in rng.choice(len(sigs), 50, replace=False):
        put("q", sigs[i], ("c2", int(i)))
    for i in range(40):
        put("other", _sig(rng.random(E) < 0.5), ("o", i))
        put("q", _sig(rng.random(16) < 0.5), ("short", i))
    assert store.export_state() == jstore.export_state()
    for trial in range(60):
        q_sig = _sig(rng.random(E) < rng.uniform(0.0, 1.0))
        excl = sigs[int(rng.integers(len(sigs)))] if trial % 3 == 0 else None
        got = store.nearest("q", (8, 16), q_sig, exclude_sig=excl)
        assert got == store._nearest_linear("q", (8, 16), q_sig,
                                            exclude_sig=excl)
        assert got == jstore.nearest("q", (8, 16), q_sig, exclude_sig=excl)
    for i in (250, 270, 299):
        got = store.nearest("q", (8, 16), sigs[i])
        assert got == store._nearest_linear("q", (8, 16), sigs[i])
        assert got == jstore.nearest("q", (8, 16), sigs[i])


def test_carry_store_index_consistent_after_eviction():
    rng = np.random.default_rng(1)
    store = CarryStore(capacity=4, sim_capacity=32, stats=ServiceStats())
    for i in range(200):
        store.put_similar(f"q{i % 3}", (8, 16), _sig(rng.random(24) < 0.5),
                          carry=i)
    assert store.sim_entries == 32
    indexed = {(qd, bk, sig)
               for (qd, bk, _nb), group in store._sim_buckets.items()
               for bin_ in group.values() for sig in bin_}
    assert indexed == set(store._sim) == set(store._sim_seq)
    for key, pc in store._sim_pop.items():
        assert pc == int(store._sim[key][0].sum())
    for _ in range(20):
        q_sig = _sig(rng.random(24) < 0.5)
        assert store.nearest("q0", (8, 16), q_sig) == \
            store._nearest_linear("q0", (8, 16), q_sig)


def test_carry_store_linear_fallback_flag():
    store = CarryStore(capacity=4, sim_capacity=8, stats=ServiceStats(),
                       sim_index=False)
    free = np.zeros(16, bool)
    free[:8] = True
    store.put_similar("q", (8, 16), _sig(free), carry="a")
    assert store.nearest("q", (8, 16), _sig(free)) == (_sig(free), "a")


class _FakeHandle:
    def __init__(self):
        self.refs = 0

    def retain(self):
        self.refs += 1

    def release(self):
        self.refs -= 1


def test_store_retains_and_releases_handles():
    cs = CarryStore(capacity=2, sim_capacity=2, stats=ServiceStats())
    h1, h2, h3 = _FakeHandle(), _FakeHandle(), _FakeHandle()
    cs.put("a", h1)
    cs.put("b", h2)
    assert (h1.refs, h2.refs) == (1, 1)
    cs.put("a", h3)                    # overwrite releases the old value
    assert (h1.refs, h3.refs) == (0, 1)
    cs.put("c", _FakeHandle())         # "a" is still the LRU entry
    assert h3.refs == 0
    cs.clear()
    assert h2.refs == 0


# ---------------------------------------------------------------------------
# DeviceCarryPool
# ---------------------------------------------------------------------------

def _carry(n=4, m=8, fill=1.0, f=2.5):
    S = np.full((n, m), fill, np.float32)
    return (S, np.float32(f), S * 0.5)


def test_pool_put_gather_roundtrip():
    pool = DeviceCarryPool(block=4, device="cpu")
    carries = [_carry(fill=float(i) + 0.1, f=float(i)) for i in range(3)]
    handles = [pool.put(c) for c in carries]
    S, f, C = pool.gather(handles)
    assert S.shape == (3, 4, 8) and S.dtype == torch.float32
    np.testing.assert_array_equal(f.numpy(), np.float32([0.0, 1.0, 2.0]))
    for i, h in enumerate(handles):
        s_i, f_i, c_i = h.materialize()
        np.testing.assert_array_equal(s_i.numpy(), carries[i][0])
        np.testing.assert_array_equal(c_i.numpy(), carries[i][2])
        np.testing.assert_array_equal(S[i].numpy(), carries[i][0])
    # the gather is a copy: a launch may overwrite it
    S.zero_()
    assert float(handles[1].materialize()[0][0, 0]) == np.float32(1.1)
    assert (pool.gathers, pool.puts) == (1, 3)


def test_pool_rows_recycle_on_release():
    pool = DeviceCarryPool(block=2, device="cpu")
    h1, h2 = pool.put(_carry(fill=1.0)), pool.put(_carry(fill=2.0))
    cap0 = pool._slabs[(4, 8)]["cap"]
    row1 = h1.row
    h1.retain()
    h1.release()                       # last ref -> row back to free list
    assert pool.live_rows == 1
    h3 = pool.put(_carry(fill=3.0))    # reuses the freed row, no growth
    assert h3.row == row1
    assert pool._slabs[(4, 8)]["cap"] == cap0
    assert pool.live_rows == 2
    np.testing.assert_array_equal(h3.materialize()[0].numpy(),
                                  np.full((4, 8), 3.0, np.float32))
    np.testing.assert_array_equal(h2.materialize()[0].numpy(),
                                  np.full((4, 8), 2.0, np.float32))


def test_pool_slab_grows_geometrically():
    pool = DeviceCarryPool(block=2, device="cpu")
    handles = [pool.put(_carry(fill=float(i))) for i in range(5)]
    assert pool._slabs[(4, 8)]["cap"] == 8     # 2 → 4 → 8
    for i, h in enumerate(handles):
        assert float(h.materialize()[0][0, 0]) == float(i)


def test_store_eviction_frees_pool_rows():
    """Warm-store evictions release their handles, so the pool's live
    rows stay bounded by the store capacities."""
    svc = _svc(warm_capacity=3, sim_capacity=2)
    specs = [(s, 6, 12) for s in range(8)]
    _burst(svc, specs)
    _burst(svc, specs)
    assert svc._pool.live_rows <= 3 + 2 + len(svc._pad_handles)
    assert len(svc._carries) <= 3


# ---------------------------------------------------------------------------
# against the JAX package's service: same problems, same draws
# ---------------------------------------------------------------------------

def _export_numpy(jsvc):
    """The reference service's stores with every carry as numpy."""
    def conv(items):
        return [(k, tuple(np.asarray(x) for x in jsvc._carry_tuple(c)))
                for k, c in items]
    return tuple(conv(items) for items in jsvc._carries.export_state())


def _outcome(r):
    return (r.tier, r.found, r.epochs_run)


def test_cold_and_tier0_drains_match_the_reference():
    """A two-bucket burst through both services: the cold drain gives
    the same outcome per request; then the port imports the reference's
    carries and both drain the burst again (Tier 0)."""
    specs = [(s, n, m) for n, m in BUCKET_ARGS for s in range(4)]
    probs = {sp: _planted(*sp) for sp in specs}
    jcfg = jpso.PSOConfig(**{k: getattr(CFG, k) for k in (
        "num_particles", "epochs", "inner_steps", "early_exit",
        "backend")})
    jsvc = jservice.MatcherService(jcfg, donate_buffers=False,
                                   persist_dir=False)

    def drain_both(port):
        for sp in specs:
            q, g = probs[sp]
            jsvc.submit(_jg(q), _jg(g), key=jax.random.PRNGKey(sp[0]),
                        workload_key=("w", sp))
            port.submit(q, g, key=_jax_stream(
                sp[0], shape_bucket(q.n, g.n), jcfg), workload_key=("w", sp))
        return jsvc.drain(), port.drain()

    jr, tr = drain_both(_svc())
    assert [_outcome(r) for r in tr] == [_outcome(r) for r in jr]
    assert all(r.tier == 2 for r in tr) and any(r.found for r in tr)
    port = _svc()
    assert port.import_state(*store_state_from_numpy(
        *_export_numpy(jsvc), device="cpu")) == (len(specs), 0)
    jr, tr = drain_both(port)
    assert [_outcome(r) for r in tr] == [_outcome(r) for r in jr]
    assert sum(r.tier == 0 for r in tr) >= 4
    for sp, r in zip(specs, tr):
        if r.found:
            _check_mapping(r.mapping, *probs[sp])


def test_tier1_rebase_matches_the_reference_after_engine_drift():
    """mobilenetv2 on the Edge platform: the reference solves one
    platform state; for each drifted state (same bucket, another free
    set) the port imports the reference's stores as they stand and both
    drain the drifted request: the same tier (a Tier-1 rebase, 0
    epochs) and a feasible mapping on the new target."""
    edge = tplat.EDGE
    pd = tpd.build_preemptible_dag(
        [(0, zoo.get_workload("mobilenetv2"), 0)],
        edge.engine_tile_capacity_macs(), window_stages=2)
    q = pd.graph
    rng = np.random.default_rng(0)

    def state():
        free = np.ones(edge.engines, bool)
        free[rng.choice(edge.engines, 6, replace=False)] = False
        return ttg.free_engine_graph(edge, free), _sig(free)

    jcfg = jpso.PSOConfig(num_particles=32, epochs=3, inner_steps=8,
                          early_exit=True, backend="ref")
    tcfg = pso.PSOConfig.from_dict(dataclasses.asdict(jcfg))
    jsvc = jservice.MatcherService(jcfg, donate_buffers=False,
                                   persist_dir=False)
    g_a, sig_a = state()
    assert jsvc.match(_jg(q), _jg(g_a), key=jax.random.PRNGKey(0),
                      workload_key=("mb", sig_a)).found
    tiers = []
    for trial in range(1, 4):
        g_b, sig_b = state()
        assert sig_b != sig_a
        port = MatcherService(tcfg, device="cpu")
        port.import_state(*store_state_from_numpy(*_export_numpy(jsvc),
                                                  device="cpu"))
        jsvc.submit(_jg(q), _jg(g_b), key=jax.random.PRNGKey(trial),
                    workload_key=("mb", sig_b))
        port.submit(q, g_b, key=_jax_stream(trial, shape_bucket(q.n, g_b.n),
                                            jcfg),
                    workload_key=("mb", sig_b))
        (jr,), (tr,) = jsvc.drain(), port.drain()
        assert _outcome(tr) == _outcome(jr)
        assert tr.found
        _check_mapping(tr.mapping, q, g_b)
        tiers.append(tr.tier)
    assert 1 in tiers


# ---------------------------------------------------------------------------
# inside the port: drain arms, census, donation, pad slots
# ---------------------------------------------------------------------------

def test_warm_drain_costs_one_host_sync():
    """An all-warm two-bucket pipelined drain resolves through exactly
    ONE blocking fetch (the census; the card test runs it under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    svc = _svc()
    specs = _warm_specs(svc)
    syncs0, drains0 = svc.stats.host_syncs, svc.stats.drains
    launches0 = svc.stats.tier0.launches
    results = _burst(svc, specs)
    assert svc.stats.drains - drains0 == 1
    assert svc.stats.host_syncs - syncs0 == 1
    assert svc.stats.tier0.launches - launches0 == 2     # one per bucket
    assert all(r.tier == 0 and r.found for r in results)
    assert svc.stats.host_bytes_transferred > 0
    for r, (seed, n, m) in zip(results, specs):
        _check_mapping(r.mapping, *_planted(seed, n, m))


def test_serial_arm_pays_a_sync_per_launch_and_per_carry():
    svc = _svc(pipelined=False)
    specs = _warm_specs(svc)
    syncs0 = svc.stats.host_syncs
    t0_launches0 = svc.stats.tier0.launches
    results = _burst(svc, specs)
    assert all(r.tier == 0 for r in results)
    launches = svc.stats.tier0.launches - t0_launches0
    assert launches == 2
    assert svc.stats.host_syncs - syncs0 == launches + 3 * len(specs)


def test_pipelined_matches_serial_bitwise():
    """A mixed easy/hard two-bucket burst gives identical mappings,
    tiers, f* and epoch counts through both drain arms, cold AND warm,
    over 3 rounds."""
    specs = [(s, n, m) for n, m in BUCKET_ARGS for s in range(4)]
    pipe = _svc()
    ser = _svc(pipelined=False)
    for _round in range(3):
        for a, b in zip(_burst(pipe, specs), _burst(ser, specs)):
            assert _fingerprint(a) == _fingerprint(b)


def test_donation_does_not_change_results():
    specs = [(s, 6, 12) for s in range(5)]
    on = _svc(donate_buffers=True)
    off = _svc(donate_buffers=False)
    for _round in range(2):
        for a, b in zip(_burst(on, specs), _burst(off, specs)):
            assert _fingerprint(a) == _fingerprint(b)
    assert off.stats.donated_launches == 0
    assert on.stats.donated_launches > 0


def test_tiered_drain_matches_untiered_per_problem():
    probs = [_planted(s, 6, 12) for s in range(4)]
    keys = [50 + i for i in range(4)]
    wks = [f"w{i}" for i in range(4)]
    svc_t = _svc(tiered=True)
    svc_u = _svc(tiered=False)
    for svc in (svc_t, svc_u):
        svc.match_many(probs, keys=keys, workload_keys=wks)     # cold
    warm_t = svc_t.match_many(probs, keys=keys, workload_keys=wks)
    warm_u = svc_u.match_many(probs, keys=keys, workload_keys=wks)
    assert any(r.tier == 0 for r in warm_t)
    for rt, ru in zip(warm_t, warm_u):
        assert rt.found == ru.found
        assert rt.epochs_run == ru.epochs_run
        if rt.found:
            np.testing.assert_array_equal(rt.mapping, ru.mapping)


def test_drain_serves_warm_via_tier0_and_sizes_swarm_to_misses():
    svc = _svc()
    specs = [(s, 6, 12) for s in range(2)]
    _burst(svc, specs)
    hq, hg = graphs.line_graph(6), graphs.line_graph(4)  # infeasible
    s0 = svc.stats_dict()
    res = svc.match_many([_planted(*sp) for sp in specs] + [(hq, hg)],
                         keys=[0, 1, 9],
                         workload_keys=[("w6x12", 0), ("w6x12", 1), "hard"])
    s1 = svc.stats_dict()
    assert [r.tier for r in res] == [0, 0, 2] and not res[2].found
    assert s1["tier0_launches"] - s0["tier0_launches"] == 1
    assert s1["batch_problems"] - s0["batch_problems"] == 1
    assert s1["coalesced_requests"] - s0["coalesced_requests"] == 3


def test_batch_slot_never_moves_a_request_s_draws():
    """A request gives the same result alone (batch class 1) and as the
    last of three (class 4, with a pad slot), and as a single ``match``:
    its draws are its own stream's."""
    probs = [_planted(s, 6, 12) for s in range(3)]
    alone = _svc(warm_start=False).match_many(probs[2:], keys=[7])
    shared = _svc(warm_start=False).match_many(probs, keys=[5, 6, 7])
    single = _svc(warm_start=False).match(*probs[2], key=7)
    assert shared[2].batch_size == 3
    assert _fingerprint(alone[0]) == _fingerprint(shared[2])
    assert _fingerprint(alone[0])[:2] == _fingerprint(single)[:2]


def test_pad_slots_prefinished_from_epoch_zero():
    svc = _svc()
    probs = [_planted(s, 6, 12) for s in range(3)]    # class 4 → 1 pad
    res = svc.match_many(probs, keys=[0, 1, 2])
    assert len(res) == 3
    assert svc.stats.pad_slots_frozen == 1
    req0 = svc._prepare(probs[0][0], probs[0][1], 3, None)
    pad_req, pad_carry = svc._pad_slot(res[0].bucket, req0, None)
    assert pad_req is not req0 and pad_req.key == 3
    outs = pso.match(*(torch.from_numpy(x) for x in
                       (pad_req.Qp, pad_req.Gp, pad_req.maskp)), CFG,
                     carry0=pad_carry.materialize())
    assert int(outs["epochs_run"]) == 0
    assert bool(outs["carry_feasible"])


def test_pad_slot_degenerate_bucket_falls_back_to_replication():
    svc = _svc()
    q, g = _planted(0, 6, 12)
    req = svc._prepare(q, g, None, None)
    like_carry = pso.default_carry(torch.from_numpy(req.maskp))
    pad_req, pad_carry = svc._pad_slot((24, 16), req, like_carry)
    assert pad_req is req and pad_carry is like_carry


def test_cache_hit_miss_accounting_across_buckets():
    svc = _svc()
    qa, ga = _planted(0, 6, 12)
    qb, gb = _planted(1, 8, 16)
    qc, gc = _planted(2, 10, 24)
    r1 = svc.match(qa, ga, key=0)
    assert not r1.compile_cache_hit and not r1.warm_hit
    r2 = svc.match(qb, gb, key=1)
    assert r2.bucket == r1.bucket and r2.compile_cache_hit
    assert not r2.warm_hit
    r3 = svc.match(qc, gc, key=2)
    assert r3.bucket != r1.bucket and not r3.compile_cache_hit
    s = svc.stats_dict()
    assert (s["calls"], s["compile_cache_misses"], s["compile_cache_hits"],
            s["jit_traces"]) == (3, 2, 1, 2)
    assert s["warm_hits"] == 0 and s["warm_misses"] == 3
    r4 = svc.match(qa, ga, key=3)
    assert r4.compile_cache_hit and r4.warm_hit


def test_compile_cache_is_bounded_lru():
    svc = _svc(cache_capacity=1)
    qa, ga = _planted(0, 6, 12)
    qc, gc = _planted(2, 10, 24)
    svc.match(qa, ga)
    svc.match(qc, gc)                       # evicts bucket A
    assert svc.stats_dict()["compile_cache_misses"] == 2
    assert len(svc._compiled) == 1
    svc.match(qa, ga)
    assert svc.stats_dict()["compile_cache_misses"] == 3


def test_service_parity_with_direct_matcher():
    """Early exit off and a bucket-exact problem: the service's result is
    the direct matcher's on the same draw stream, bit for bit."""
    q, g = _planted(1, 8, 16)
    assert shape_bucket(8, 16) == (8, 16)
    cfg = CFG.replace(early_exit=False)
    res_s = _svc(cfg, early_exit=False, warm_start=False).match(q, g, key=7)
    res_d = IMMSchedMatcher(cfg, device="cpu").match(q, g, stream=7)
    assert res_s.found == res_d.found
    assert res_s.feasible_count == res_d.feasible_count
    assert res_s.f_star == res_d.f_star
    np.testing.assert_array_equal(res_s.all_feasible, res_d.all_feasible)
    if res_d.found:
        np.testing.assert_array_equal(res_s.mapping, res_d.mapping)


def test_infeasible_problem_reports_not_found():
    res = _svc().match(graphs.line_graph(6), graphs.line_graph(4))
    assert not res.found and res.epochs_run == CFG.epochs


def test_single_match_tier1_after_drift_and_without_similarity():
    """The single-call path rebases a similar stored state (Tier 1) and
    never probes the similarity store with ``similarity=False``."""
    edge = tplat.EDGE
    pd = tpd.build_preemptible_dag(
        [(0, zoo.get_workload("mobilenetv2"), 0)],
        edge.engine_tile_capacity_macs(), window_stages=2)
    q = pd.graph
    rng = np.random.default_rng(2)
    cfg = pso.PSOConfig(num_particles=32, epochs=3, inner_steps=8,
                        backend="ref")
    for similarity in (True, False):
        svc = _svc(cfg, similarity=similarity)
        tiers = []
        for trial in range(3):
            free = np.ones(edge.engines, bool)
            free[rng.choice(edge.engines, 6, replace=False)] = False
            g = ttg.free_engine_graph(edge, free)
            r = svc.match(q, g, key=trial, workload_key=("mb", _sig(free)))
            assert r.found
            _check_mapping(r.mapping, q, g)
            tiers.append(r.tier)
        s = svc.stats_dict()
        if similarity:
            assert 1 in tiers and s["tier1_hits"] >= 1
        else:
            assert s["sim_lookups"] == 0 and s["tier1_launches"] == 0


# ---------------------------------------------------------------------------
# async front end
# ---------------------------------------------------------------------------

FE_CFG = pso.PSOConfig(num_particles=8, epochs=2, inner_steps=4,
                       backend="ref")


def _frontend(max_depth=8, policy="shed", slack=0.1, classes=(1, 2, 4)):
    svc = _svc(FE_CFG, batch_classes=classes)
    return svc, AsyncServiceFrontEnd(svc, max_depth=max_depth,
                                     policy=policy,
                                     slack_threshold_s=slack)


def test_frontend_batch_full_trigger():
    svc, fe = _frontend()
    probs = [_planted(i, 6, 12) for i in range(4)]
    rids = [fe.submit(q, g, deadline=100.0, now=0.0) for q, g in probs]
    assert fe.depth == 0
    s = svc.stats_dict()
    assert s["fe_drains"] == 1 and s["fe_drain_batch_full"] == 1
    assert s["fe_queue_peak"] == 4
    for rid in rids:
        assert fe.take_result(rid) is not None


def test_frontend_deadline_trigger_and_poll():
    svc, fe = _frontend(slack=0.1)
    q, g = _planted(0, 6, 12)
    rid = fe.submit(q, g, deadline=1.0, now=0.0)
    with pytest.raises(KeyError):
        fe.take_result(rid)
    assert fe.next_deadline_check() == pytest.approx(0.9)
    assert fe.poll(now=0.5) == 0
    assert fe.poll(now=0.95) == 1
    s = svc.stats_dict()
    assert s["fe_drain_deadline"] == 1
    assert s["fe_wait_s"] == pytest.approx(0.95)
    assert fe.take_result(rid) is not None


def test_frontend_shed_policy_bounds_depth():
    svc, fe = _frontend(max_depth=2, slack=0.0)
    q, g = _planted(1, 6, 12)
    kept = [fe.submit(q, g, deadline=1e9, now=0.0) for _ in range(2)]
    shed = fe.submit(q, g, deadline=1e9, now=0.0)
    assert fe.depth == 2
    s = svc.stats_dict()
    assert s["fe_shed"] == 1
    assert s["fe_admitted"] == 2 and s["fe_submitted"] == 3
    assert fe.take_result(shed) is None
    assert fe.flush(now=1.0) == 2
    assert svc.stats_dict()["fe_drain_flush"] == 1
    for rid in kept:
        assert fe.take_result(rid) is not None


def test_frontend_block_policy_forces_drain():
    svc, fe = _frontend(max_depth=2, slack=0.0, policy="block")
    q, g = _planted(2, 6, 12)
    rids = [fe.submit(q, g, deadline=1e9, now=float(i)) for i in range(3)]
    s = svc.stats_dict()
    assert s["fe_shed"] == 0 and s["fe_forced_drains"] == 1
    assert fe.depth == 1
    fe.flush(now=3.0)
    for rid in rids:
        assert fe.take_result(rid) is not None


def test_frontend_counters_flow_through_stats_dict():
    svc, fe = _frontend()
    q, g = _planted(3, 6, 12)
    fe.submit(q, g, deadline=50.0, now=0.0)
    fe.flush(now=1.0)
    s = svc.stats_dict()
    for key in ("fe_submitted", "fe_admitted", "fe_shed",
                "fe_forced_drains", "fe_drains", "fe_drain_deadline",
                "fe_drain_batch_full", "fe_drain_flush",
                "fe_queue_peak", "fe_wait_s"):
        assert key in s
    assert s["fe_submitted"] == s["fe_admitted"] == 1
    assert s["fe_drains"] == s["fe_drain_flush"] == 1


def test_stack_carries_mixes_seeds_cold_priors_and_handles():
    """A Tier-2 launch stacks a Tier-1 seed (device planes, f* a numpy
    -inf), a cold prior and a pooled carry into (B, ...) inputs."""
    svc = _svc()
    q, g = _planted(0, 6, 12)
    req = svc._prepare(q, g, None, None)
    cold = svc._cold_carry(req)
    S = torch.rand(*req.maskp.shape)
    seed = (S, np.float32(-np.inf), S * 0.5)
    handle = svc._pool.put((S.numpy() + 1, np.float32(3.0), S.numpy()))
    for pipelined in (True, False):
        svc.pipelined = pipelined
        Sb, fb, Cb = svc._stack_carries([seed, cold, handle])
        assert Sb.shape == (3, *req.maskp.shape) and fb.shape == (3,)
        assert fb.dtype == torch.float32
        np.testing.assert_array_equal(fb.numpy(), [-np.inf, -np.inf, 3.0])
        assert torch.equal(Sb[0], S) and torch.equal(Cb[1], cold[2])
        assert torch.equal(Sb[2], S + 1)
