"""The port's distributed matcher on ``torch.distributed`` (gloo, CPU
tensors), against the JAX package's ``build_distributed_match`` and the
port's own single-device paths.

Each world of ranks is a set of processes on this host (``FileStore``
rendezvous under ``tmp_path``, a process-group timeout and a subprocess
timeout, so a hang fails in seconds); the JAX side runs in its own
process with 8 fake CPU devices, as ``tests/test_matcher_sharded.py``
does. Both sides see the same problems, and the port's shards draw what
the reference's shards drew (``split(key, D)[d]``, then ``split(·, T)``),
handed in as callable streams. At the reference test's size (n = 8,
m = 16, N = 24, K = 10):

* particle-sharded match on meshes (1, 1), (2, 1), (4, 1) and (2, 2),
  with ``axis_names`` ("data", "model") and ("data",): at T = 1 the
  epochs run, mappings and feasible flags equal, f* trace, S* and S̄
  within rtol 1e-5 / atol 1e-4 (the consensus sums in another order);
  at T = 5 with early exit the same found and epochs, every mapping
  flagged feasible, T·N·D mappings; every rank the same bits;
* the problem-axis ``match_batch`` (B = 8, D = 4) bit for bit the
  single-device ``match_batch``; the small-B regime (B = 2, D = 4) bit
  for bit the per-problem distributed match;
* revalidation in both regimes bit for bit the single-device
  ``revalidate_batch``, and the reference's ``ok`` and ``mapping``;
* a mesh ``MatcherService`` (D = 2): the same results on both ranks,
  every mapping feasible, the single-device service's tiers and
  device-pool traffic, one snapshot written and restored by both.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import graphs, pso
from repro_torch.core.matcher import collect_result, shard_streams
from repro_torch.core.service import MatcherService
from repro_torch.launch import mesh as mesh_lib

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-4
N, K, SEED = 24, 10, 7
#: (mesh shape, axis_names) of the particle-sharded cases
CASES = [((d, mo), names) for d, mo in ((1, 1), (2, 1), (4, 1), (2, 2))
         for names in (("data", "model"), ("data",))]
WORLD_TIMEOUT_S = 400


def _case_id(case):
    (d, mo), names = case
    return f"{d}x{mo}-{'+'.join(names)}"


def _shards(case):
    (d, mo), names = case
    return d * mo if len(names) == 2 else d


def _cfg(T):
    return dict(num_particles=N, epochs=T, inner_steps=K, backend="ref",
                early_exit=T > 1)


REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core import pso
    from repro.core.matcher import (build_distributed_match,
                                    build_distributed_revalidate_batch)
    jax.config.update("jax_platform_name", "cpu")
    cases, cfgs, seed = eval(sys.argv[3])
    inp = np.load(sys.argv[1])
    Q, G, mask = (jnp.asarray(inp[k]) for k in ("Q", "G", "mask"))
    out = {}

    def epoch_draws(key, cfg, n, m):
        k_init, k_steps = jax.random.split(key)
        init = jax.random.uniform(k_init, (cfg.num_particles, n, m),
                                  minval=0.05, maxval=1.0)
        steps = jax.vmap(lambda k: jax.random.uniform(
            k, (cfg.num_particles, 3)))(
            jax.random.split(k_steps, cfg.inner_steps))
        return np.asarray(init), np.asarray(steps)

    for ci, ((d, mo), names) in enumerate(cases):
        mesh = jax.make_mesh((d, mo), ("data", "model"),
                             devices=jax.devices()[:d * mo])
        D = int(np.prod([mesh.shape[a] for a in names]))
        for T, kw in cfgs:
            cfg = pso.PSOConfig(**kw)
            keys = jax.random.split(jax.random.PRNGKey(seed), D)
            fn = build_distributed_match(Q.shape, mesh, cfg, names)
            outs = fn(keys, Q, G, mask, pso.default_carry(mask))
            for k, v in outs.items():
                out[f"c{ci}.T{T}.{k}"] = np.asarray(v)
            n, m = mask.shape
            draws = [[epoch_draws(k, cfg, n, m)
                      for k in jax.random.split(keys[s], T)]
                     for s in range(D)]
            out[f"c{ci}.T{T}.draw_init"] = np.array(
                [[e[0] for e in s] for s in draws])
            out[f"c{ci}.T{T}.draw_steps"] = np.array(
                [[e[1] for e in s] for s in draws])
    mesh = jax.make_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])
    rcfg = pso.PSOConfig(**cfgs[-1][1])
    for B in (8, 2):
        rfn = build_distributed_revalidate_batch(
            tuple(inp["Mb"].shape[1:]), mesh, rcfg, ("data",), B)
        outs = rfn(*(jnp.asarray(inp[k][:B]) for k in ("Qb", "Gb", "Mb")),
                   tuple(jnp.asarray(inp[k][:B]) for k in ("cS", "cf", "cC")))
        for k in ("ok", "mapping"):
            out[f"reval{B}.{k}"] = np.asarray(outs[k])
    np.savez(sys.argv[2], **out)
    print("REFERENCE-OK")
''')

WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    from repro_torch.core import graphs, pso
    from repro_torch.core.matcher import (
        build_distributed_match, build_distributed_match_batch,
        build_distributed_revalidate_batch, shard_streams)
    from repro_torch.core.service import MatcherService
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inp_path, ref_path, out_path, spec = sys.argv[3:8]
    cases, cfgs, seed, svc_spec = eval(spec)
    inp = np.load(inp_path)
    ref = np.load(ref_path)
    mesh_lib.init_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world, device="cpu", timeout_s=120)
    out = {}
    t = lambda k: torch.from_numpy(inp[k])
    Q, G, mask = t("Q"), t("G"), t("mask")
    meshes = {}
    for ci, ((d, mo), names) in enumerate(cases):
        if d * mo != world:
            continue
        if (d, mo) not in meshes:
            meshes[(d, mo)] = mesh_lib.make_host_mesh(d, mo, backend="gloo",
                                                      device="cpu")
        mesh = meshes[(d, mo)]
        for T, kw in cfgs:
            cfg = pso.PSOConfig(**kw)
            D = mesh_lib.mesh_axes(mesh, names).size
            init = ref[f"c{ci}.T{T}.draw_init"]
            steps = ref[f"c{ci}.T{T}.draw_steps"]
            streams = [(lambda e, s=s: dict(init=init[s, e],
                                           steps=steps[s, e]))
                       for s in range(D)]
            fn = build_distributed_match(Q.shape, mesh, cfg, names)
            for k, v in fn(streams, Q, G, mask).items():
                out[f"c{ci}.T{T}.{k}"] = np.asarray(v)
    if world == 4:
        mesh = mesh_lib.make_host_mesh(4, 1, backend="gloo", device="cpu")
        cfg = pso.PSOConfig(**cfgs[-1][1])
        Qb, Gb, Mb = t("Qb"), t("Gb"), t("Mb")
        carry = (t("cS"), t("cf"), t("cC"))
        seeds = [100 + b for b in range(8)]
        fn = build_distributed_match_batch((8, 16), mesh, cfg, ("data",), 8)
        for k, v in fn(seeds, Qb, Gb, Mb).items():
            out[f"batch8.{k}"] = np.asarray(v)
        fn = build_distributed_match_batch((8, 16), mesh, cfg, ("data",), 2)
        for k, v in fn(seeds[:2], Qb[:2], Gb[:2], Mb[:2]).items():
            out[f"batch2.{k}"] = np.asarray(v)
        single = build_distributed_match((8, 16), mesh, cfg, ("data",))
        for b in range(2):
            for k, v in single(shard_streams(seeds[b], 4), Qb[b], Gb[b],
                               Mb[b]).items():
                out[f"single{b}.{k}"] = np.asarray(v)
        for B in (8, 2):
            fn = build_distributed_revalidate_batch((8, 16), mesh, cfg,
                                                    ("data",), B)
            for k, v in fn(Qb[:B], Gb[:B], Mb[:B],
                           tuple(c[:B] for c in carry)).items():
                out[f"reval{B}.{k}"] = np.asarray(v)
    if world == 2:
        mesh = mesh_lib.make_host_mesh(2, 1, backend="gloo", device="cpu")
        probs = [tuple(graphs.Graph.build(inp[f"{k}{i}"], inp[f"{k}t{i}"])
                       for k in ("sq", "sg"))
                 for i in range(svc_spec["count"])]
        cfg = pso.PSOConfig(**svc_spec["cfg"])
        persist_dir = svc_spec["persist_dir"]
        svc = MatcherService(cfg, mesh=mesh, device="cpu",
                             persist_dir=persist_dir)
        seeds = svc_spec["seeds"]
        for rnd in ("cold", "warm"):
            for i, r in enumerate(svc.match_many(probs, keys=seeds)):
                out[f"svc.{rnd}.{i}.mapping"] = (
                    np.zeros(0) if r.mapping is None else r.mapping)
                out[f"svc.{rnd}.{i}.meta"] = np.array(
                    [r.tier, r.found, r.epochs_run])
            stats = svc.stats_dict()
            out[f"svc.{rnd}.pool"] = np.array(
                [stats[k] for k in svc_spec["pool"]])
        out["svc.step"] = np.array(svc.save_snapshot())
        fresh = MatcherService(cfg, mesh=mesh, device="cpu",
                               persist_dir=persist_dir)
        assert fresh.restore_snapshot() is not None
        for i, r in enumerate(fresh.match_many(probs, keys=seeds)):
            out[f"svc.restored.{i}.meta"] = np.array(
                [r.tier, r.found, r.epochs_run])
        out["svc.restored_carries"] = np.array(
            fresh.stats_dict()["restored_carries"])
        out["svc.collectives"] = np.array(mesh_lib.collectives.count)
    np.savez(out_path, **out)
    print("WORKER-OK", rank)
''')


SVC = dict(count=6, seeds=[30 + i for i in range(6)],
           cfg=dict(num_particles=16, epochs=3, inner_steps=6,
                    backend="ref"),
           # the device-pool keys of ``stats_dict`` compared with the
           # single-device service's
           pool=("pool_puts", "pool_gathers", "pool_live_rows",
                 "donated_launches"))


def _planted(rng, n, m, edge_prob=0.35):
    q = graphs.random_dag(rng, n, edge_prob)
    q, _ = graphs.topological_relabel(q)
    return q, graphs.embed_query_in_target(rng, q, m)


def _inputs():
    """The problems both sides see: one (8, 16) problem for the
    particle-sharded cases, 8 for the batches and revalidation (with
    carries: the planted mapping's one-hot for even problems, a uniform
    row for odd ones) and 6 service requests."""
    rng = np.random.default_rng(SEED)
    q, g = _planted(rng, 8, 16)
    inp = {"Q": q.adj, "G": g.adj,
           "mask": graphs.compatibility_mask(q, g).astype(np.uint8)}
    probs = [_planted(rng, 8, 16) for _ in range(8)]
    inp["Qb"] = np.stack([p.adj for p, _ in probs])
    inp["Gb"] = np.stack([t.adj for _, t in probs])
    inp["Mb"] = np.stack([graphs.compatibility_mask(p, t).astype(np.uint8)
                          for p, t in probs])
    # carries: a feasible mapping found by a short single-device swarm
    # (f* -2) for even problems, the uniform prior with no decision
    # (f* -inf, so never ok) for odd ones
    cS = inp["Mb"].astype(np.float32)
    cS /= cS.sum(-1, keepdims=True)
    cf = np.full(8, -np.inf, np.float32)
    for b in range(0, 8, 2):
        M = pso.best_feasible(pso.match(
            *(torch.from_numpy(inp[k][b]) for k in ("Qb", "Gb", "Mb")),
            pso.PSOConfig(num_particles=16, epochs=2, inner_steps=6,
                          early_exit=True), stream=b))
        assert M is not None
        cS[b], cf[b] = M, -2.0
    inp["cS"], inp["cC"], inp["cf"] = cS, cS.copy(), cf
    for i in range(SVC["count"]):
        sq, sg = _planted(rng, 6 + 2 * (i % 2), 16 + 16 * (i % 3 == 2))
        for k, gr in (("sq", sq), ("sg", sg)):
            inp[f"{k}{i}"], inp[f"{k}t{i}"] = gr.adj, gr.types
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference process and the port's worlds of 1, 2 and 4 ranks,
    all at once; returns the inputs, the reference's outputs and each
    world's per-rank outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(tmp / "inp.npz", **inp)
    cfgs = [(1, _cfg(1)), (5, _cfg(5))]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    ref = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp / "inp.npz"),
         str(tmp / "ref.npz"), repr((CASES, cfgs, SEED))],
        env=env, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S)
    assert "REFERENCE-OK" in ref.stdout, ref.stderr[-4000:]
    svc = dict(SVC, persist_dir=str(tmp / "persist"))
    spec = repr((CASES, cfgs, SEED, svc))
    worlds = {}
    for world in (1, 2, 4):
        cmds = [[sys.executable, "-c", WORKER, str(r), str(world),
                 str(tmp / f"store{world}"), str(tmp / "inp.npz"),
                 str(tmp / "ref.npz"), str(tmp / f"w{world}r{r}.npz"), spec]
                for r in range(world)]
        worlds[world] = cmds
    results = mesh_lib.run_ranks(
        [c for w in (1, 2, 4) for c in worlds[w]],
        timeout_s=WORLD_TIMEOUT_S, env=env)
    for _, so, se in results:
        assert "WORKER-OK" in so, se[-4000:]
    out = {w: [dict(np.load(tmp / f"w{w}r{r}.npz")) for r in range(w)]
           for w in (1, 2, 4)}
    return dict(inp=inp, ref=dict(np.load(tmp / "ref.npz")), out=out,
                persist=tmp / "persist")


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _ranks_equal(outs, prefix):
    """Every rank's leaves under ``prefix`` are rank 0's, bit for bit
    (``host_syncs`` counts each rank's own fetches)."""
    keys = sorted(k for k in outs[0]
                  if k.startswith(prefix) and not k.endswith("host_syncs"))
    assert keys
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def _feasible(M, Q, G):
    M = np.asarray(M, np.int64)
    return bool((M.sum(1) == 1).all() and (M.sum(0) <= 1).all()
                and ((M @ G.astype(np.int64) @ M.T) >= Q).all())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_particle_sharded_match_one_epoch_matches_reference(runs, case):
    ci, D = CASES.index(case), _shards(case)
    outs = runs["out"][case[0][0] * case[0][1]]
    _ranks_equal(outs, f"c{ci}.")
    got, ref = outs[0], runs["ref"]
    p = f"c{ci}.T1."
    assert got[p + "mappings"].shape == (1, N * D, 8, 16)
    for k in ("epochs_run", "feasible", "mappings", "prune_sweeps",
              "carry_feasible"):
        np.testing.assert_array_equal(got[p + k], ref[p + k], err_msg=k)
    for k in ("f_star_trace", "S_star", "S_bar", "f_star", "fitness"):
        _close(got[p + k], ref[p + k])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_particle_sharded_match_five_epochs_outcomes(runs, case):
    ci, D = CASES.index(case), _shards(case)
    got, ref = runs["out"][case[0][0] * case[0][1]][0], runs["ref"]
    p = f"c{ci}.T5."
    res = collect_result({k[len(p):]: v for k, v in got.items()
                          if k.startswith(p)})
    assert res.all_feasible.shape == (5 * N * D,)
    assert res.found == bool(ref[p + "feasible"].any())
    assert res.epochs_run == int(ref[p + "epochs_run"])
    Q, G = runs["inp"]["Q"], runs["inp"]["G"]
    for M in res.all_mappings[res.all_feasible]:
        assert _feasible(M, Q, G)


def test_problem_axis_match_batch_is_the_single_device_one(runs):
    outs = runs["out"][4]
    _ranks_equal(outs, "batch8.")
    inp = runs["inp"]
    want = pso.match_batch(
        *(torch.from_numpy(inp[k]) for k in ("Qb", "Gb", "Mb")),
        pso.PSOConfig(**_cfg(5)), streams=[100 + b for b in range(8)])
    for k, v in want.items():
        if k != "host_syncs":
            np.testing.assert_array_equal(outs[0][f"batch8.{k}"], v.numpy(),
                                          err_msg=k)


def test_small_batch_regime_is_the_per_problem_distributed_match(runs):
    outs = runs["out"][4]
    _ranks_equal(outs, "batch2.")
    got, inp = outs[0], runs["inp"]
    for b in range(2):
        for k in ("mappings", "feasible", "fitness", "f_star_trace"):
            np.testing.assert_array_equal(got[f"batch2.{k}"][:, b],
                                          got[f"single{b}.{k}"])
        for k in ("S_star", "f_star", "S_bar", "epochs_run",
                  "carry_mapping", "prune_sweeps"):
            np.testing.assert_array_equal(got[f"batch2.{k}"][b],
                                          got[f"single{b}.{k}"])
        assert got[f"batch2.mappings"].shape[2] == 4 * N
        flagged = got["batch2.mappings"][:, b][got["batch2.feasible"][:, b]]
        for M in flagged:
            assert _feasible(M, inp["Qb"][b], inp["Gb"][b])


@pytest.mark.parametrize("B", [8, 2])
def test_revalidate_both_regimes(runs, B):
    outs, inp, ref = runs["out"][4], runs["inp"], runs["ref"]
    _ranks_equal(outs, f"reval{B}.")
    want = pso.revalidate_batch(
        *(torch.from_numpy(inp[k][:B]) for k in ("Qb", "Gb", "Mb")),
        pso.PSOConfig(**_cfg(5)),
        tuple(torch.from_numpy(inp[k][:B]) for k in ("cS", "cf", "cC")))
    for k, v in want.items():
        np.testing.assert_array_equal(outs[0][f"reval{B}.{k}"], v.numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(outs[0][f"reval{B}.ok"],
                                  ref[f"reval{B}.ok"])
    np.testing.assert_array_equal(outs[0][f"reval{B}.mapping"],
                                  ref[f"reval{B}.mapping"])
    assert outs[0][f"reval{B}.ok"].any() and not outs[0][f"reval{B}.ok"].all()


def test_mesh_service_two_ranks(runs):
    outs, inp = runs["out"][2], runs["inp"]
    _ranks_equal(outs, "svc.")
    probs = [tuple(graphs.Graph.build(inp[f"{k}{i}"], inp[f"{k}t{i}"])
                   for k in ("sq", "sg")) for i in range(SVC["count"])]
    single = MatcherService(pso.PSOConfig(**SVC["cfg"]), device="cpu",
                            persist_dir=False)
    for rnd in ("cold", "warm"):
        res = single.match_many(probs, keys=SVC["seeds"])
        tiers = [int(outs[0][f"svc.{rnd}.{i}.meta"][0])
                 for i in range(SVC["count"])]
        assert tiers == [r.tier for r in res], rnd
        # one carry path: the mesh service keeps its carries in its
        # device pool, row for row as the single-device service does
        stats = single.stats_dict()
        np.testing.assert_array_equal(outs[0][f"svc.{rnd}.pool"],
                                      [stats[k] for k in SVC["pool"]])
        for i, (q, g) in enumerate(probs):
            M = outs[0][f"svc.{rnd}.{i}.mapping"]
            if M.size:
                assert _feasible(M, q.adj, g.adj)
    assert [int(outs[0][f"svc.cold.{i}.meta"][0])
            for i in range(SVC["count"])] == [2] * SVC["count"]
    # the restored store serves the warm drain's decisions again
    for i in range(SVC["count"]):
        np.testing.assert_array_equal(outs[0][f"svc.restored.{i}.meta"],
                                      outs[0][f"svc.warm.{i}.meta"])
    assert any(outs[0][f"svc.restored.{i}.meta"][0] == 0
               for i in range(SVC["count"]))
    snaps = sorted(os.listdir(runs["persist"] / "snapshots"))
    assert snaps == [f"step_{int(outs[0]['svc.step']):09d}"]
    assert int(outs[0]["svc.restored_carries"]) == SVC["count"]
    assert int(outs[0]["svc.collectives"]) > 0


def test_shard_streams_rule():
    assert shard_streams(5, 1) == [5]
    assert shard_streams(5, 4) == [20, 21, 22, 23]
    assert shard_streams([1, 2], 2) == [1, 2]
    assert len({s for seed in range(8) for s in shard_streams(seed, 4)}) \
        == 32
    with pytest.raises(ValueError):
        shard_streams(lambda t: {}, 2)
    with pytest.raises(ValueError):
        shard_streams([1, 2, 3], 2)


def test_backend_string_and_mesh_checks():
    assert mesh_lib.backend_string("gloo", "cpu") == "gloo"
    assert mesh_lib.backend_string("gloo", "cuda") == "cuda:gloo,cpu:gloo"
    assert mesh_lib.backend_string("nccl", "cuda") == "nccl"
    with pytest.raises(ValueError):
        mesh_lib.backend_string("nccl", "cpu")
    with pytest.raises(ValueError):
        mesh_lib.backend_string("mpi", "cpu")
    with pytest.raises(RuntimeError):
        mesh_lib.make_host_mesh(1, 1, backend="gloo", device="cpu")
