"""The port's swarm matcher against the JAX package's, on the same draws.

``jax.random`` cannot be reproduced with torch, so the tests repeat the
key splits of the JAX ``_epoch_start`` (``core/pso.py``) to build the
draws JAX consumed, and hand them to the port as ``draws``. Float
outputs must agree within rtol 1e-5 / atol 1e-4, integer outputs bit for
bit, and whole runs give the same found / epochs_run / prune_sweeps with
every mapping feasible under the JAX ``ref.is_feasible``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pso as jpso
from repro.kernels import ref as jref
from repro_torch.accel import platform as tplat
from repro_torch.accel import target_graph as ttg
from repro_torch.core import graphs as tgraphs
from repro_torch.core import preemptible_dag as tpd
from repro_torch.core import pso as tpso
from repro_torch.workloads import zoo as tzoo

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


def _epoch_draws(key, cfg, n, m):
    """The random inputs ``_epoch_start`` derives from one epoch key."""
    if cfg.gumbel_tau > 0:
        k_init, k_steps, k_gum = jax.random.split(key, 3)
    else:
        (k_init, k_steps), k_gum = jax.random.split(key), None
    N = cfg.num_particles
    init = jax.random.uniform(k_init, (N, n, m), minval=0.05, maxval=1.0)
    steps = jax.vmap(lambda k: jax.random.uniform(k, (N, 3)))(
        jax.random.split(k_steps, cfg.inner_steps))
    out = dict(init=np.asarray(init), steps=np.asarray(steps))
    if k_gum is not None:
        out["gumbel"] = np.asarray(
            jax.random.gumbel(k_gum, (N, n, m), dtype=jnp.float32))
    return out


def batch_draws(keys, cfg, n, m):
    """``match_batch``'s draws: (T, P, ...) arrays for (P,) problem keys."""
    per = [[_epoch_draws(k, cfg, n, m)
            for k in jax.random.split(key, cfg.epochs)] for key in keys]
    return {name: torch.from_numpy(np.stack(
        [np.stack([per[b][t][name] for b in range(len(keys))])
         for t in range(cfg.epochs)])) for name in per[0][0]}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _planted(seed, n, m, edge_prob=0.35):
    rng = np.random.default_rng(seed)
    q = tgraphs.random_dag(rng, n, edge_prob)
    q, _ = tgraphs.topological_relabel(q)
    return q, tgraphs.embed_query_in_target(rng, q, m)


def _padded_batch(problems):
    """Stack planted problems padded to one bucket (as the service does)."""
    n = max(q.n for q, _ in problems)
    m = max(g.n for _, g in problems)
    bucket = tpd.shape_bucket(n, m)
    Qs, Gs, Ms = zip(*(tpd.pad_problem(q.adj, g.adj,
                                       tgraphs.compatibility_mask(q, g),
                                       *bucket) for q, g in problems))
    return np.stack(Qs), np.stack(Gs), np.stack(Ms)


def test_pso_config_matches_the_jax_package():
    jf = [(f.name, f.default) for f in dataclasses.fields(jpso.PSOConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tpso.PSOConfig)]
    assert tf == jf
    jcfg = jpso.PSOConfig(num_particles=8, quantized=True, backend="pallas",
                          gumbel_tau=0.2)
    tcfg = tpso.PSOConfig.from_dict(dataclasses.asdict(jcfg))
    assert tcfg == tpso.PSOConfig(num_particles=8, quantized=True,
                                  gumbel_tau=0.2)


@pytest.mark.parametrize("quantized,tau", [(False, 0.0), (True, 0.3)])
def test_run_epoch_and_batch_match_jax(quantized, tau):
    problems = [_planted(s, 8, 16) for s in (11, 12)]
    Qb, Gb, Mb = _padded_batch(problems)
    cfg_kw = dict(num_particles=12, inner_steps=4, quantized=quantized,
                  gumbel_tau=tau, backend="ref")
    jcfg, tcfg = jpso.PSOConfig(**cfg_kw), tpso.PSOConfig(**cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    n, m = Mb.shape[1:]
    draws = [_epoch_draws(k, jcfg, n, m) for k in keys]
    # single problem
    jc, jo = jpso.run_epoch(jpso.default_carry(jnp.asarray(Mb[0])), keys[0],
                            jnp.asarray(Qb[0]), jnp.asarray(Gb[0]),
                            jnp.asarray(Mb[0]), jcfg)
    d0 = {k: _t(v) for k, v in draws[0].items()}
    tc, to = tpso.run_epoch(tpso.default_carry(_t(Mb[0])), d0, _t(Qb[0]),
                            _t(Gb[0]), _t(Mb[0]), tcfg)
    for a, b in zip(tc, jc):
        _close(a, b)
    for k in jo:
        _close(to[k], jo[k])
    # batch
    jcb, job = jpso.run_epoch_batch(
        jpso.default_carry_batch(jnp.asarray(Mb)), keys, jnp.asarray(Qb),
        jnp.asarray(Gb), jnp.asarray(Mb), jcfg)
    db = {k: _t(np.stack([d[k] for d in draws]))
          for k in draws[0]}
    tcb, tob = tpso.run_epoch_batch(tpso.default_carry_batch(_t(Mb)), db,
                                    _t(Qb), _t(Gb), _t(Mb), tcfg)
    for a, b in zip(tcb, jcb):
        _close(a, b)
    for k in job:
        _close(tob[k], job[k])


def _check_found(mapping, Q, G):
    assert bool(jref.is_feasible(jnp.asarray(mapping), jnp.asarray(Q),
                                 jnp.asarray(G)))


CFGS = [dict(num_particles=16, epochs=2, inner_steps=4),
        dict(num_particles=16, epochs=3, inner_steps=4, quantized=True,
             early_exit=True)]


@pytest.mark.parametrize("seed,n,m,c", [(0, 6, 12, 1), (1, 8, 16, 0),
                                         (2, 10, 24, 0), (2, 10, 24, 1)])
def test_match_matches_jax_on_planted(seed, n, m, c):
    cfg_kw = CFGS[c]
    q, g = _planted(seed, n, m)
    Q, G, M = (np.asarray(x) for x in (q.adj, g.adj,
                                       tgraphs.compatibility_mask(q, g)))
    jcfg = jpso.PSOConfig(backend="ref", **cfg_kw)
    tcfg = tpso.PSOConfig(backend="ref", **cfg_kw)
    key = jax.random.PRNGKey(seed)
    jo = jpso.match(key, jnp.asarray(Q), jnp.asarray(G), jnp.asarray(M), jcfg)
    d = batch_draws([key], jcfg, n, m)
    to = tpso.match(_t(Q), _t(G), _t(M), tcfg,
                    draws={k: v[:, 0] for k, v in d.items()})
    for k in ("epochs_run", "prune_sweeps", "feasible", "carry_feasible"):
        _close(to[k], jo[k])
    _close(to["fitness"], jo["fitness"])
    assert to["host_syncs"] <= jcfg.epochs
    jbest, tbest = jpso.best_feasible(jo), tpso.best_feasible(to)
    assert (jbest is None) == (tbest is None)
    if tbest is not None:
        _check_found(tbest, Q, G)
    if cfg_kw.get("early_exit"):
        # warm start from the JAX carry: both take the carry fast path
        # (or both run) and agree on the outcome
        carry = tuple(np.asarray(jo[k]) for k in ("S_star", "f_star",
                                                  "S_bar"))
        jw = jpso.match(key, jnp.asarray(Q), jnp.asarray(G), jnp.asarray(M),
                        jcfg, tuple(map(jnp.asarray, carry)))
        tw = tpso.match(_t(Q), _t(G), _t(M), tcfg,
                        tpso.carry_from_numpy(carry, "cpu"),
                        draws={k: v[:, 0] for k, v in d.items()})
        for k in ("carry_feasible", "carry_mapping", "epochs_run",
                  "feasible"):
            _close(tw[k], jw[k])


def test_scan_epochs_and_elite_consensus_match_jax():
    """The single-problem scan over ``run_epoch`` equals ``match``'s
    epochs, and the standalone elite consensus equals the JAX one."""
    q, g = _planted(1, 8, 16)
    Q, G, M = (_t(x) for x in (q.adj, g.adj,
                               tgraphs.compatibility_mask(q, g)))
    cfg = tpso.PSOConfig(num_particles=8, epochs=2, inner_steps=3,
                         prune_mask=False, backend="ref")
    d = batch_draws([jax.random.PRNGKey(2)], cfg, 8, 16)
    d = {k: v[:, 0] for k, v in d.items()}

    def run_one(carry, t):
        carry, outs = tpso.run_epoch(carry, {k: v[t] for k, v in d.items()},
                                     Q, G, M, cfg)
        del outs["S_final"]
        return carry, outs

    carry, outs, n_run, syncs = tpso.scan_epochs(
        run_one, tpso.default_carry(M), 8, 16, cfg)
    ref_outs = tpso.match(Q, G, M, cfg, draws=d)
    for k in ("mappings", "feasible", "fitness", "f_star_trace"):
        _close(outs[k], ref_outs[k].numpy())
    assert int(n_run) == cfg.epochs and syncs == 0
    S_all, f_all = outs["mappings"][-1].float(), outs["fitness"][-1]
    jcfg = jpso.PSOConfig(num_particles=8)
    got = tpso.elite_consensus(S_all, f_all, cfg)
    want = jpso.elite_consensus(jnp.asarray(S_all.numpy()),
                                jnp.asarray(f_all.numpy()), jcfg)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("cfg_kw", CFGS)
def test_match_batch_matches_jax_on_planted(cfg_kw):
    problems = [_planted(s, n, m) for s, n, m in
                ((0, 6, 12), (1, 8, 16), (2, 10, 24), (3, 8, 16))]
    Qb, Gb, Mb = _padded_batch(problems)
    jcfg = jpso.PSOConfig(backend="ref", **cfg_kw)
    tcfg = tpso.PSOConfig(backend="ref", **cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(9), len(problems))
    jo = jpso.match_batch(keys, jnp.asarray(Qb), jnp.asarray(Gb),
                          jnp.asarray(Mb), jcfg)
    to = tpso.match_batch(_t(Qb), _t(Gb), _t(Mb), tcfg,
                          draws=batch_draws(keys, jcfg, *Mb.shape[1:]))
    for k in ("epochs_run", "prune_sweeps", "feasible", "mappings"):
        _close(to[k], jo[k])
    _close(to["f_star"], jo["f_star"])
    from repro.core.matcher import collect_batch_results as jcollect
    from repro_torch.core.matcher import collect_batch_results as tcollect
    jres = jcollect(jo, len(problems))
    tres = tcollect(to, len(problems))
    for b, (jr, tr) in enumerate(zip(jres, tres)):
        assert (tr.found, tr.epochs_run, tr.prune_sweeps) == (
            jr.found, jr.epochs_run, jr.prune_sweeps)
        if tr.found:
            _check_found(tr.mapping, Qb[b], Gb[b])


def test_unet_window_on_cloud_full_size_and_revalidate_from_jax_carry():
    """The scheduler's real problem: unet at window_stages=8 on the Cloud
    platform with 96 free engines, bucket (48, 112), quantized with early
    exit. Then Tier 0: revalidate_batch warm-started from the JAX carry."""
    plat = tplat.CLOUD
    free = np.zeros(plat.engines, dtype=bool)
    free[np.random.default_rng(0).choice(plat.engines, 96,
                                         replace=False)] = True
    pd = tpd.build_preemptible_dag([(0, tzoo.get_workload("unet"), 0)],
                                   plat.engine_tile_capacity_macs(),
                                   window_stages=8)
    q, _ = tgraphs.topological_relabel(pd.graph)
    g = ttg.free_engine_graph(plat, free)
    bucket = tpd.shape_bucket(q.n, g.n)
    assert bucket == (48, 112)
    Qp, Gp, Mp = tpd.pad_problem(q.adj, g.adj,
                                 tgraphs.compatibility_mask(q, g), *bucket)
    kw = dict(quantized=True, early_exit=True, backend="ref")
    jcfg, tcfg = jpso.PSOConfig(**kw), tpso.PSOConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    jQ, jG, jM = (jnp.asarray(x[None]) for x in (Qp, Gp, Mp))
    jo = jpso.match_batch(keys, jQ, jG, jM, jcfg)
    to = tpso.match_batch(_t(Qp[None]), _t(Gp[None]), _t(Mp[None]), tcfg,
                          draws=batch_draws(keys, jcfg, *bucket))
    for k in ("epochs_run", "prune_sweeps", "feasible"):
        _close(to[k], jo[k])
    assert bool(np.asarray(jo["feasible"]).any())
    best = tpso.best_feasible({k: to[k][:, 0] for k in
                               ("feasible", "fitness", "mappings")})
    _check_found(best, Qp, Gp)
    # Tier 0 from the JAX carry
    jcarry = tuple(np.asarray(jo[k]) for k in ("S_star", "f_star", "S_bar"))
    jr = jpso.revalidate_batch(jQ, jG, jM, jcfg, tuple(map(jnp.asarray,
                                                           jcarry)))
    tr = tpso.revalidate_batch(_t(Qp[None]), _t(Gp[None]), _t(Mp[None]),
                               tcfg, tpso.carry_from_numpy(jcarry, "cpu"))
    for k in ("ok", "ok_rebase", "mapping", "prune_sweeps"):
        _close(tr[k], jr[k])
    _close(tr["fitness"], jr["fitness"])
    if bool(tr["ok"][0]):
        _check_found(tr["mapping"][0].numpy(), Qp, Gp)


def _same_problem_outs(a, b):
    """Every leaf of two single-problem ``match`` outputs bit for bit."""
    assert set(a) == set(b)
    for k in a:
        if k == "host_syncs":
            continue
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("cfg_kw", CFGS + [dict(
    num_particles=12, epochs=2, inner_steps=3, quantized=True,
    gumbel_tau=0.3)])
def test_match_batch_draws_each_problem_from_its_own_stream(cfg_kw):
    """``match_batch`` of [a, b] with seeds [s_a, s_b]: problem b gives
    the bits ``match(b)`` gives alone with s_b (its epochs, early exit
    and carry included), and swapping the order changes nothing."""
    problems = [_planted(s, n, m) for s, n, m in ((0, 6, 12), (2, 10, 24))]
    Qb, Gb, Mb = (_t(x) for x in _padded_batch(problems))
    cfg = tpso.PSOConfig(backend="ref", **cfg_kw)
    seeds = [11, 12]
    ab = tpso.match_batch(Qb, Gb, Mb, cfg, streams=seeds)
    ba = tpso.match_batch(Qb.flip(0), Gb.flip(0), Mb.flip(0), cfg,
                          streams=seeds[::-1])

    def pick(outs, b):
        return {k: (v if k == "host_syncs" else
                    v[:, b] if k in tpso.PER_EPOCH else v[b])
                for k, v in outs.items()}

    for b in range(2):
        alone = tpso.match(Qb[b], Gb[b], Mb[b], cfg, stream=seeds[b])
        _same_problem_outs(pick(ab, b), alone)
        _same_problem_outs(pick(ba, 1 - b), alone)
    # a generator stream draws what its seed draws
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    _same_problem_outs(pick(tpso.match_batch(Qb, Gb, Mb, cfg, streams=gens),
                            0), pick(ab, 0))


def test_callable_streams_of_the_jax_draws_match_jax_per_problem():
    """``batch_draws`` still gives JAX's draws problem by problem: handed
    in as one callable stream per problem, in either order, they give
    the outputs of ``draws=`` and of the JAX package's ``match_batch``."""
    problems = [_planted(s, n, m) for s, n, m in
                ((0, 6, 12), (1, 8, 16), (3, 8, 16))]
    Qb, Gb, Mb = _padded_batch(problems)
    kw = dict(num_particles=16, epochs=3, inner_steps=4, early_exit=True,
              backend="ref")
    jcfg, tcfg = jpso.PSOConfig(**kw), tpso.PSOConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(4), len(problems))
    d = batch_draws(keys, jcfg, *Mb.shape[1:])
    jo = jpso.match_batch(keys, jnp.asarray(Qb), jnp.asarray(Gb),
                          jnp.asarray(Mb), jcfg)
    by_draws = tpso.match_batch(_t(Qb), _t(Gb), _t(Mb), tcfg, draws=d)

    def stream(b):
        return lambda t: {k: v[t, b] for k, v in d.items()}

    order = [2, 0, 1]
    by_streams = tpso.match_batch(_t(Qb[order]), _t(Gb[order]),
                                  _t(Mb[order]), tcfg,
                                  streams=[stream(b) for b in order])
    for k in ("epochs_run", "prune_sweeps", "feasible", "mappings",
              "f_star", "S_star"):
        got = by_streams[k]
        want = by_draws[k][:, order] if k in tpso.PER_EPOCH \
            else by_draws[k][order]
        assert torch.equal(got, want), k
    for k in ("epochs_run", "feasible"):
        _close(by_draws[k], jo[k])


#: the scheduler's 8-request burst (``chip_smoke.py``'s main path)
BURST = ("pnasnet", "unet", "nasnet", "resnet50", "mobilenetv2",
         "efficientnet", "deepseek-7b", "qwen-7b")


def _burst_problems():
    """The burst as ``IMMSchedScheduler._real_match_batch`` builds it:
    zoo workloads at window_stages=8 on the Cloud platform with a seeded
    set of 96 free engines, relabelled and padded to one bucket."""
    plat = tplat.CLOUD
    free = np.zeros(plat.engines, dtype=bool)
    free[np.random.default_rng(0).choice(plat.engines, 96,
                                         replace=False)] = True
    g = ttg.free_engine_graph(plat, free)
    qs = []
    for i, name in enumerate(BURST):
        pd = tpd.build_preemptible_dag([(i, tzoo.get_workload(name), 0)],
                                       plat.engine_tile_capacity_macs(),
                                       window_stages=8)
        qs.append(tgraphs.topological_relabel(pd.graph)[0])
    n_pad = max(tpd.shape_bucket(q.n, g.n)[0] for q in qs)
    m_pad = -(-(g.n + n_pad - min(q.n for q in qs)) // 16) * 16
    padded = [tpd.pad_problem(q.adj, g.adj, tgraphs.compatibility_mask(q, g),
                              n_pad, m_pad) for q in qs]
    return tuple(np.stack(x) for x in zip(*padded))


@pytest.mark.parametrize("cfg_kw", [dict(quantized=True),
                                    dict(quantized=False)])
def test_burst_outcomes_match_jax_full_size(cfg_kw):
    """The 8-request burst at full width (bucket (56, 144), N = 64, T = 4,
    K = 12, early exit) from the JAX keys: the same epochs_run,
    prune_sweeps and per-epoch feasible flags; then Tier 0 from the JAX
    carry gives the same ok, ok_rebase and mapping. The carries
    themselves may drift (ROADMAP Queue 3: the fitness sums' order)."""
    Qb, Gb, Mb = _burst_problems()
    assert Mb.shape == (8, 56, 144)
    kw = dict(early_exit=True, backend="ref", **cfg_kw)
    jcfg, tcfg = jpso.PSOConfig(**kw), tpso.PSOConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(0), len(BURST))
    jQ, jG, jM = (jnp.asarray(x) for x in (Qb, Gb, Mb))
    jo = jpso.match_batch(keys, jQ, jG, jM, jcfg)
    to = tpso.match_batch(_t(Qb), _t(Gb), _t(Mb), tcfg,
                          draws=batch_draws(keys, jcfg, *Mb.shape[1:]))
    for k in ("epochs_run", "prune_sweeps", "feasible"):
        _close(to[k], jo[k])
    found = np.asarray(jo["feasible"]).any(axis=(0, 2))
    assert 0 < int(found.sum()) < len(BURST)
    jcarry = tuple(np.asarray(jo[k]) for k in ("S_star", "f_star", "S_bar"))
    jr = jpso.revalidate_batch(jQ, jG, jM, jcfg,
                               tuple(map(jnp.asarray, jcarry)))
    tr = tpso.revalidate_batch(_t(Qb), _t(Gb), _t(Mb), tcfg,
                               tpso.carry_from_numpy(jcarry, "cpu"))
    for k in ("ok", "ok_rebase", "mapping"):
        _close(tr[k], jr[k])
    for b in np.where(tr["ok"].numpy())[0]:
        _check_found(tr["mapping"][b].numpy(), Qb[b], Gb[b])
