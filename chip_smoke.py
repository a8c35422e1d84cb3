#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card (name and power limit from nvidia-smi), torch and CUDA;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (timed);
  3. kernels: at the main paths' shapes (P = 8 problems, N = 64
     particles, K = 12 steps, bucket (56, 144)) each of the nine kernel
     entries against its plain PyTorch version on the same inputs, float
     and quantized, τ = 0 and τ > 0: integers bit for bit, floats within
     rtol 1e-5 / atol 1e-4 (``epoch_fused``, ``masked_argmax`` and
     both ``edge_fitness`` bodies bit for bit; the float body also once at
     (P, N, n, m) = (1, 64, 203, 233), where its tiles pass a block's
     shared memory and live in device scratch); both timed with CUDA
     events, the kernel as the median of 5 runs (the entries the split
     epoch calls per problem are called and timed per problem),
     quantized and, for ``epoch_fused``, float;
  4. the main path: 8 scheduling requests built as the IMMSched
     scheduler builds them (zoo workloads at window_stages=8 on the Cloud
     platform with a seeded set of 96 free engines, relabelled and padded
     to one bucket), solved by ``match_batch`` (quantized, early exit),
     re-validated by ``revalidate_batch`` (Tier 0), plus one float-config
     ``IMMSchedMatcher.match``; every returned mapping must be feasible
     and every kernel of the path must have been launched;
  4b. the matcher service (``core.service.MatcherService``, quantized,
     early exit) on the same 8 requests, bucketed by the service itself:
     a cold drain, a warm drain, an all-warm drain (every request at
     Tier 0, exactly one host sync) and a drift drain on a target with 4
     free engines swapped (Tier 1), then a float-config service match of
     unet, cold and warm; every served mapping must be feasible and each
     of the five main-path kernels must have been launched through the
     service. Measurement only: the warm and the all-warm drain under
     the profiler and the Tier-0 host phases per bucket;
  4c. the scheduler: the port's ``Simulator`` with ``IMMSchedScheduler`` in
     real mode (``validate=True``) on the Cloud platform at the burst's
     swarm width, over a compound-Poisson stream of bursts of 8
     (efficientnet, nasnet, pnasnet, about 70% urgent); each urgent
     arrival event is one drain of the service. Fails if the run is
     truncated or unfinished, if an invariant or the tier accounting
     fails, if a found mapping is infeasible, or if a quantized main-path
     kernel was not launched by the phase. The same simulation through
     the ``ref`` suite on the card must give the same ``SimResult`` (wall
     clocks and the suite's name aside) and every drain the same tiers,
     found, epochs and mappings. Prints one JSON line (tiers, drains,
     host syncs, matches, wall times, and the simulator's own scheduling
     times, which are cost-model seconds). Then the same scenario through
     all six schedulers in analytic mode (no launch): ``speedup_table``
     and ``energy_efficiency``;
  5. the split (pre-fusion) epoch: ``core.split_epoch.split_epoch``
     through the ``cuda`` suite on each problem of the burst, float and
     quantized, plus ``masked_argmax`` through the seam on each returned
     S*; every kernel of the path must have been launched, and the
     results must equal the fused epoch's (``epoch_fused`` →
     ``epoch_finish``, τ = 0) on the same inputs; both timed per problem;
  6. path parity: the same burst at a reduced swarm through the ``cuda``
     and the ``ref`` suite on the same draws must give the same first
     epoch;
  7. profile: device time by kernel over one more ``match_batch`` of the
     burst, and the device's idle share of its wall time.

The second-to-last line is the ``kernels`` JSON record (one row per
kernel entry and one for ``epoch_fused``'s float branch; ``launches``
counts device launches on the main or split path, ``launches_per_call``
divides them by the wrapper calls that made them, ``service_launches``
counts the launches of phase 4b, ``sched_launches`` those of phase 4c;
the float branch's launches are counted by its wrapper on their own and
left out of the ``epoch_fused`` row),
the last line ``{"ok": true, "device": {...}}``. With ``--out DIR`` the
details (a JSON record and the profiler's table) are also written to DIR.
"""
import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORKLOADS = ("pnasnet", "unet", "nasnet", "resnet50", "mobilenetv2",
             "efficientnet", "deepseek-7b", "qwen-7b")
N_FREE, FREE_SEED, SEED = 96, 0, 0
N, K = 64, 12
# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK = {"fp32": 67e12, "int8": 1979e12}
KERNELS = {   # entry → (CUDA source, TPU kernel it replaces)
    "prune_fixpoint": ("src/repro_torch/csrc/prune_fixpoint.cu",
                       "src/repro/kernels/prune_fixpoint.py:102"),
    "edge_fitness": ("src/repro_torch/csrc/pso_fitness.cu",
                     "src/repro/kernels/pso_fitness.py:111"),
    "edge_fitness_quantized": ("src/repro_torch/csrc/fitness_quantized.cu",
                               "src/repro/kernels/pso_fitness.py:132"),
    "epoch_fused": ("src/repro_torch/csrc/epoch_fused.cu",
                    "src/repro/kernels/epoch_fused.py:251"),
    "epoch_finish": ("src/repro_torch/csrc/finish_fused.cu",
                     "src/repro/kernels/finish_fused.py:373"),
    "pso_update": ("src/repro_torch/csrc/pso_update.cu",
                   "src/repro/kernels/pso_update.py:84"),
    "ullmann_refine_step": ("src/repro_torch/csrc/ullmann_refine.cu",
                            "src/repro/kernels/ullmann_refine.py:61"),
    "greedy_project": ("src/repro_torch/csrc/argmax_project.cu",
                       "src/repro/kernels/argmax_project.py:63"),
    "masked_argmax": ("src/repro_torch/csrc/argmax_project.cu",
                      "src/repro/kernels/argmax_project.py:97"),
}
#: the float branch of epoch_fused, timed and listed as its own row
FLOAT_EPOCH = "epoch_fused_float"
#: entries held bit for bit against their plain version in phase 3 (the
#: others' integer outputs are equal too; their float outputs are held
#: within the tolerance)
BITWISE = ("epoch_fused", "masked_argmax", "edge_fitness",
           "edge_fitness_quantized")
#: (P, N, n, m) of phase 3's extra float fitness call: tiles past a
#: block's shared memory
FITNESS_LARGE = (1, 64, 203, 233)
#: the kernels of the main path, in phase 4 and through the service
MAIN_KERNELS = ("prune_fixpoint", "edge_fitness", "edge_fitness_quantized",
                "epoch_fused", "epoch_finish")
#: the kernels the split epoch phase drives (the fitness entries too)
SPLIT_KERNELS = ("pso_update", "ullmann_refine_step", "greedy_project",
                 "masked_argmax", "edge_fitness", "edge_fitness_quantized")
#: phase 4c: the scheduler's real-mode simulation on the Cloud platform,
#: at the burst's swarm width; the quantized main-path kernels it must
#: launch (the scheduler's service is quantized, so no float fitness)
SCHED_SCENARIO = dict(complexity="middle", rate_hz=30, horizon=0.4,
                      burst_size=8, burst_frac=0.8, urgent_frac=0.7, seed=5)
SCHED_SWARM = dict(num_particles=N, epochs=4, inner_steps=K)
SCHED_WINDOW = 8
SCHED_KERNELS = ("prune_fixpoint", "edge_fitness_quantized", "epoch_fused",
                 "epoch_finish")
SCHEDULERS = ("immsched", "isosched", "prema", "planaria", "moca", "cdmsa")


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def split_float(counts):
    """Per-kernel counts with ``epoch_fused``'s split in two rows: the
    float branch's (counted on its own by the wrapper) and the rest."""
    counts = dict(counts)
    counts["epoch_fused"] -= counts[FLOAT_EPOCH]
    return counts


def _outs(x):
    """A kernel's outputs as a tuple (one tensor or several)."""
    return x if isinstance(x, tuple) else (x,)


def cuda_ms(fn, reps, warm=1):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# requests, as IMMSchedScheduler._real_match_batch builds them
# ---------------------------------------------------------------------------

def free_engines():
    """The Cloud platform and its seeded set of ``N_FREE`` free engines."""
    from repro_torch.accel import platform
    plat = platform.CLOUD
    free = np.zeros(plat.engines, dtype=bool)
    free[np.random.default_rng(FREE_SEED).choice(plat.engines, N_FREE,
                                                 replace=False)] = True
    return plat, free


def build_requests():
    from repro_torch.accel import target_graph
    from repro_torch.core import graphs, preemptible_dag as pdag
    from repro_torch.workloads import zoo
    plat, free = free_engines()
    tgt = target_graph.free_engine_graph(plat, free)
    cap = plat.engine_tile_capacity_macs()
    reqs = []
    for i, name in enumerate(WORKLOADS):
        pd = pdag.build_preemptible_dag([(i, zoo.get_workload(name), 0)],
                                        cap, window_stages=8)
        q, order = graphs.topological_relabel(pd.graph)
        reqs.append(dict(name=name, q=q, order=order,
                         mask=graphs.compatibility_mask(q, tgt)))
    # one bucket for the burst, with room for every problem's dummy PEs
    n_pad = max(pdag.shape_bucket(r["q"].n, tgt.n)[0] for r in reqs)
    m_pad = -(-(tgt.n + n_pad - min(r["q"].n for r in reqs)) // 16) * 16
    padded = [pdag.pad_problem(r["q"].adj, tgt.adj, r["mask"], n_pad, m_pad)
              for r in reqs]
    Qb, Gb, Mb = (torch.from_numpy(np.stack(x)).cuda()
                  for x in zip(*padded))
    return reqs, tgt, (n_pad, m_pad), Qb, Gb, Mb


def feasible_np(M, Q, G):
    M = np.asarray(M, dtype=np.int64)
    return bool((M.sum(1) == 1).all() and (M.sum(0) <= 1).all()
                and ((M @ np.asarray(G, np.int64) @ M.T)
                     >= np.asarray(Q, np.int64)).all())


# ---------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once over
# HBM bandwidth, against operations over the peak rate of their type
# ---------------------------------------------------------------------------

def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(byts, ops):
    t_bytes = byts / HBM_BYTES_S
    t_ops = sum(v / PEAK[k] for k, v in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(Q, G, mask, x, outs, quantized, refine_iters=6,
                  elite_k=16):
    P, n, m = mask.shape
    nnzG = float(G.sum())                       # sum over problems
    nnzQ = float(Q.sum())
    sweep_ops = 2.0 * (2 * n * m * m + 2 * n * n * m)   # 4 0/1 products
    fit_f32 = N * (n * nnzG + P * (2.0 * n * n * m + 3 * n * n))
    fit_int = fit_f32
    pr_out, pr_sweeps = outs["prune_fixpoint"]
    b = {}
    b["prune_fixpoint"] = bound(
        nbytes(mask, Q, G, pr_out, pr_sweeps),
        {"int8": sweep_ops * float(pr_sweeps.sum())})
    b["edge_fitness"] = bound(nbytes(x["S"], Q, G) + P * N * 4,
                              {"fp32": fit_f32})
    b["edge_fitness_quantized"] = bound(nbytes(x["S_q"], Q, G) + P * N * 4,
                                        {"int8": fit_int})
    upd = 15.0 * P * N * n * m                 # update, clip, normalize
    ep_ops = {"fp32": K * (upd + (0 if quantized else fit_f32))}
    if quantized:
        ep_ops["int8"] = K * (fit_int + 6.0 * P * N * n * m)
    ep_out = outs["epoch_fused"]
    b["epoch_fused"] = bound(
        nbytes(x["S"], x["V"], x["S"], x["f_local"], x["S_star"],
               x["f_star"], x["S_bar"], mask, Q, G, x["r_all"], *ep_out),
        ep_ops)
    fin_out = outs["epoch_finish"]
    proj = 3.0 * P * N * n * (m * 8)            # 3 projections, per row
    feas = 2.0 * P * N * nnzQ / P
    b["epoch_finish"] = bound(
        nbytes(x["S"], x["f_local"], mask, Q, G, *fin_out),
        {"int8": P * N * refine_iters * sweep_ops + proj + feas,
         "fp32": 2.0 * P * elite_k * n * m})
    # per call of the split epoch (one problem): the mean over the burst
    S_new, V_new = outs["pso_update"][:2]
    b["pso_update"] = bound(
        nbytes(x["S"], x["V"], x["S"], x["S_star"], x["S_bar"], mask,
               x["r_all"][:, 0]) / P + nbytes(S_new, V_new),
        {"fp32": 15.0 * N * n * m})
    swept = outs["ullmann_refine_step"][0]
    b["ullmann_refine_step"] = bound(2 * nbytes(swept) + nbytes(Q, G) / P,
                                     {"int8": N * sweep_ops})
    b["greedy_project"] = bound(
        nbytes(x["S"], mask) / P + nbytes(outs["greedy_project"][0]),
        {"fp32": float(N * n * n * m)})
    b["masked_argmax"] = bound(
        nbytes(x["S_star"], mask) / P + nbytes(*outs["masked_argmax"][:2]),
        {"fp32": float(n * m)})
    return b


def split_phase(pso, Qb, Gb, Mb, x, counters):
    """The split epoch through the ``cuda`` suite on every problem of the
    burst, float and quantized, then ``masked_argmax`` through the seam on
    each returned S*: launches counted over exactly that run. Then each
    result is held against the fused epoch (``epoch_fused`` →
    ``epoch_finish``, τ = 0) on the same inputs, and both are timed per
    problem."""
    from repro_torch.core import split_epoch
    from repro_torch.kernels import backend, cases, ref
    from repro_torch.kernels.epoch_fused import epoch_fused_cuda
    from repro_torch.kernels.finish_fused import epoch_finish_cuda
    P = Mb.shape[0]
    keys = ("S", "V", "S", "f_local", "S_star", "f_star", "S_bar")

    def args(p):
        return (*(x[k][p] for k in keys), Mb[p], Qb[p], Gb[p], x["r_all"][p])

    def fused(sl, cfg):
        S, S_star, f_star, f_trace, f_last = epoch_fused_cuda(
            *(x[k][sl] for k in keys), Mb[sl], Qb[sl], Gb[sl],
            x["r_all"][sl], omega=cfg.omega, c1=cfg.c1, c2=cfg.c2,
            c3=cfg.c3, v_max=cfg.v_max, quantized=cfg.quantized)
        tail = epoch_finish_cuda(
            S, f_last, None, Mb[sl], Qb[sl], Gb[sl], gumbel_tau=0.0,
            refine_threshold=cfg.refine_threshold,
            refine_iters=cfg.refine_iters, elite_k=pso.elite_k_for(cfg),
            consensus_temp=cfg.consensus_temp)
        return (S, S_star, f_star, f_trace, f_last, *tail)

    cfgs = {q: pso.PSOConfig(num_particles=N, inner_steps=K, quantized=q,
                             backend="cuda") for q in (False, True)}
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    got = {}
    for q, cfg in cfgs.items():
        bk = backend.for_config(cfg)
        for p in range(P):
            out = split_epoch.split_epoch(*args(p), cfg)
            got[q, p] = (out, bk.masked_argmax(out[1], Mb[p]))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: counters[k].count for k in SPLIT_KERNELS}
    calls = {k: counters[k].calls for k in SPLIT_KERNELS}
    log(f"split epoch: {2 * P} epochs in {wall * 1e3:.1f} ms, launches "
        f"{launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the split epoch path")

    names = ("S_final", "S_star", "f_star", "f_trace", "f_last", "M_hat",
             "feasible")
    s_bar_err, times = 0.0, []
    for q, cfg in cfgs.items():
        want = fused(slice(None), cfg)
        for p in range(P):
            out, (val, idx) = got[q, p]
            for k, name in enumerate(names):
                if not torch.equal(out[k], want[k][p]):
                    fail(f"split epoch (quantized={q}, problem {p}): "
                         f"{name} differs from the fused epoch")
            if not torch.equal(pso._fitness(out[0], Qb[p], Gb[p], cfg),
                               want[4][p]):
                fail(f"split epoch (quantized={q}, problem {p}): the "
                     f"recomputed fitness differs from the fused f_last")
            try:
                s_bar_err = max(s_bar_err, cases.compare(out[7], want[7][p]))
                cases.compare((val, idx), ref.masked_argmax(out[1], Mb[p]))
            except AssertionError as e:
                fail(f"split epoch (quantized={q}, problem {p}): {e}")
            split_ms = cuda_ms(lambda: split_epoch.split_epoch(*args(p), cfg),
                               reps=2)
            fused_ms = cuda_ms(lambda: fused(slice(p, p + 1), cfg), reps=5)
            times.append(dict(problem=p, quantized=q, split_ms=split_ms,
                              fused_ms=fused_ms))
            log(json.dumps(dict(split_vs_fused=p, quantized=q,
                                split_ms=split_ms, fused_ms=fused_ms)))
    log(f"split epoch == fused epoch on {P} problems, float and quantized "
        f"(S_bar max abs err {s_bar_err:.3g}); masked_argmax == plain")
    # the card's idle share of one split and one fused epoch (problem 0)
    idle = {}
    for path, fn in (("split", lambda: split_epoch.split_epoch(
            *args(0), cfgs[True])), ("fused", lambda: fused(slice(0, 1),
                                                            cfgs[True]))):
        _, wall_ms, rows = profiled(fn)
        busy = sum(r[1] for r in rows)
        idle[path] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                          idle_share=1.0 - busy / max(wall_ms, 1e-9),
                          device_launches=sum(r[2] for r in rows))
    log(f"split vs fused epoch under the profiler: {json.dumps(idle)}")
    return dict(launches=launches, calls=calls, wall_s=wall,
                s_bar_max_abs_err=s_bar_err,
                times=times, profile=idle)


def _tier_delta(stats, before):
    """Per-tier launches, checked, hits and wall ms since ``before``."""
    out = {}
    for name in ("tier0", "tier1", "tier2"):
        t, b = getattr(stats, name), getattr(before, name)
        out[name] = dict(launches=t.launches - b.launches,
                         checked=t.checked - b.checked, hits=t.hits - b.hits,
                         wall_ms=(t.wall_s - b.wall_s) * 1e3)
    return out


def tier0_phases(pso, svc, reqs, picks, tgt, sig):
    """Step 0 of the Tier-0 hand kernel (measurement only): the host
    phases of ``revalidate_batch`` on the service's own warm inputs, per
    bucket, each timed with ``time.perf_counter`` between two
    synchronizes. The phases' outputs are held against one
    ``revalidate_batch`` call on the same inputs."""
    from repro_torch.kernels import backend
    cfg = svc.cfg
    bk = backend.for_config(cfg)
    groups = {}
    for i in picks:
        req = svc._prepare(reqs[i]["q"], tgt, SEED + i, (reqs[i]["name"], sig))
        groups.setdefault(req.bucket, []).append(req)
    rows = []
    for bucket, rq in sorted(groups.items()):
        Qb, Gb, Mb = svc._upload_problems(rq)
        handles = [svc._carries._exact[svc._warm_key(r)] for r in rq]
        carry0 = svc._stack_carries(handles)
        ms = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out

        mask, _ = timed("prune", lambda: bk.prune_fixpoint_batch(
            Mb, Qb, Gb, cfg.prune_iters))
        S_rb, f0, _ = timed("rebase_carry",
                            lambda: pso.rebase_carry(carry0, mask))
        M_c = timed("structured_project", lambda: bk.structured_project(
            S_rb, Qb, Gb, mask).to(torch.uint8))
        f_c = timed("fitness", lambda: pso._fitness(
            M_c.float()[:, None], Qb, Gb, cfg)[:, 0])
        feas = timed("is_feasible", lambda: bk.is_feasible(M_c, Qb, Gb))
        want = timed("revalidate_batch", lambda: pso.revalidate_batch(
            Qb, Gb, Mb, cfg, carry0))
        ok = feas & (f0 > float("-inf")) & (f0 >= cfg.early_exit_fitness)
        if not (torch.equal(M_c, want["mapping"]) and torch.equal(
                ok, want["ok"]) and torch.equal(f_c, want["fitness"])):
            fail(f"Tier-0 phases at {bucket} differ from revalidate_batch")
        rows.append(dict(bucket=list(bucket), problems=len(rq), **ms))
        log(json.dumps(dict(tier0_phases_ms=rows[-1])))
    return rows


def service_phase(pso, reqs, counters, out_dir):
    """The matcher service at the burst's full width: the 8 requests
    submitted as the scheduler names them, bucketed by the service
    itself. Drains, in order: cold (Tier 2), warm, all-warm (the requests
    the warm drain served at Tier 0: every one must be served at Tier 0
    again for exactly one host sync), and a drift drain on a target with
    4 free engines swapped (Tier 1); then a float-config match of unet,
    cold and warm. Every served mapping is checked on the host against
    the unpadded query and target, and each of the five main-path kernels
    must have been launched through the service. Then, measurement only:
    the warm and the all-warm drain under the profiler and the Tier-0
    host phases."""
    from repro_torch.accel import target_graph
    from repro_torch.core.service import MatcherService
    plat, free = free_engines()
    tgt = target_graph.free_engine_graph(plat, free)
    sig = target_graph.free_engine_signature(free)
    drift = free.copy()
    rng = np.random.default_rng(FREE_SEED + 1)
    drift[rng.choice(np.where(free)[0], 4, replace=False)] = False
    drift[rng.choice(np.where(~free)[0], 4, replace=False)] = True
    tgt_drift = target_graph.free_engine_graph(plat, drift)
    sig_drift = target_graph.free_engine_signature(drift)
    cfg = pso.PSOConfig(quantized=True, early_exit=True)
    svc = MatcherService(cfg, device="cuda")
    drains = {}

    def drain(label, picks, target, tsig):
        before = copy.deepcopy(svc.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in picks:
            svc.submit(reqs[i]["q"], target, key=SEED + i,
                       workload_key=(reqs[i]["name"], tsig))
        res = svc.drain()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for i, r in zip(picks, res):
            if r.found and not feasible_np(r.mapping, reqs[i]["q"].adj,
                                           target.adj):
                fail(f"service drain {label}: {reqs[i]['name']}'s mapping "
                     f"is infeasible")
        line = dict(drain=label, wall_ms=wall,
                    tiers=_tier_delta(svc.stats, before),
                    host_syncs=svc.stats.host_syncs - before.host_syncs,
                    found=sum(r.found for r in res), requests=len(res),
                    served=[[reqs[i]["name"], r.tier, r.found, r.epochs_run]
                            for i, r in zip(picks, res)],
                    buckets=sorted({tuple(r.bucket) for r in res}))
        log(json.dumps(line))
        drains[label] = line
        return res

    for c in counters.values():
        c.reset()
    everyone = list(range(len(reqs)))
    drain("cold", everyone, tgt, sig)
    warm = drain("warm", everyone, tgt, sig)
    picks = [i for i, r in zip(everyone, warm) if r.tier == 0 and r.found]
    if not picks:
        fail("the warm drain served no request at Tier 0")
    res = drain("all_warm", picks, tgt, sig)
    if not all(r.tier == 0 and r.found for r in res):
        fail("the all-warm drain served a request off Tier 0")
    if drains["all_warm"]["host_syncs"] != 1:
        fail(f"the all-warm drain made {drains['all_warm']['host_syncs']} "
             f"host syncs, not 1")
    drain("drift", everyone, tgt_drift, sig_drift)
    # the float config (the service's default): unet, cold then warm
    fsvc = MatcherService(device="cuda")
    unet = WORKLOADS.index("unet")
    for label in ("float_cold", "float_warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fsvc.match(reqs[unet]["q"], tgt, key=SEED + unet,
                       workload_key=("unet", sig))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if r.found and not feasible_np(r.mapping, reqs[unet]["q"].adj,
                                       tgt.adj):
            fail(f"service {label}: infeasible mapping")
        drains[label] = dict(drain=label, wall_ms=wall, tier=r.tier,
                             found=r.found, epochs_run=r.epochs_run,
                             host_syncs=r.host_syncs, bucket=list(r.bucket))
        log(json.dumps(drains[label]))
    launches = split_float({k: counters[k].count
                            for k in (*MAIN_KERNELS, FLOAT_EPOCH)})
    log(f"launches through the service: {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched through the service")

    # step 0 of the Tier-0 hand kernel, measurement only: a warm drain of
    # the 8 (Tier 0 in every bucket, then Tier 2 for the misses) and the
    # all-warm drain under the profiler, then the Tier-0 host phases on
    # the warm drain's inputs, bucket by bucket
    def warm_drain(picked):
        for i in picked:
            svc.submit(reqs[i]["q"], tgt, key=SEED + i,
                       workload_key=(reqs[i]["name"], sig))
        return svc.drain()
    profiles = {}
    for label, picked in (("warm", everyone), ("all_warm", picks)):
        prof, wall_ms, rows = profiled(lambda: warm_drain(picked))
        busy = sum(r[1] for r in rows)
        profiles[label] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                               idle_share=1.0 - busy / max(wall_ms, 1e-9),
                               device_launches=sum(r[2] for r in rows),
                               top=[dict(kernel=k[:60], ms=ms, calls=c)
                                    for k, ms, c in rows[:6]])
        log(f"service {label} drain under the profiler: "
            f"{json.dumps(profiles[label])}")
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"profile_service_{label}.txt").write_text(
                prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30))
    phases = tier0_phases(pso, svc, reqs, everyone, tgt, sig)
    return dict(drains=drains, launches=launches,
                stats=svc.stats_dict(), profiles=profiles,
                tier0_phases=phases)


def sched_phase(pso, counters):
    """Phase 4c, the scheduler: the port's ``Simulator`` with the port's
    ``IMMSchedScheduler`` in real mode on the Cloud platform (window 8,
    N = 64, T = 4, K = 12; the scheduler makes the swarm quantized and
    the service adds early exit) over a compound-Poisson burst stream of
    efficientnet, nasnet and pnasnet, about 70% urgent. Every urgent
    arrival event is one ``MatcherService.match_many`` drain, which a
    wrapper (here, not in the package) times and checks: every mapping
    the service returns as found must be feasible. Fails if the run is
    truncated or leaves a task unfinished, if the simulator's invariants
    fail (``validate=True``: ``check_invariants`` holds among them that
    the tier decisions sum to the matcher decisions), or if a quantized
    main-path kernel was not launched by the phase. Then the same
    simulation through the ``ref`` suite on the card: the same
    ``SimResult`` (wall clocks and the suite's name aside), and in every
    drain the same tiers, found, epochs and mappings. Then the ``cuda``
    run once more under the profiler, for the card's idle share (the
    profiler's own host cost would inflate the timed run's wall). Then
    the same scenario through all six schedulers in analytic mode, which
    must launch nothing."""
    from repro_torch.accel import platform
    from repro_torch.core.service import MatcherService
    from repro_torch.sched import SimConfig, Simulator, get_scheduler
    from repro_torch.sched import metrics
    from repro_torch.sched.tasks import make_burst_scenario
    kw = dict(SCHED_SCENARIO)
    sc = make_burst_scenario(kw.pop("complexity"), **kw)
    runs = []        # per simulation, one record per drain
    orig = MatcherService.match_many

    def match_many(self, problems, **kwargs):
        syncs = self.stats.host_syncs
        t0 = time.perf_counter()
        res = orig(self, problems, **kwargs)
        wall = time.perf_counter() - t0
        found = 0
        for (q, g), r in zip(problems, res):
            if r.found:
                found += 1
                if not feasible_np(r.mapping, q.adj, g.adj):
                    fail(f"scheduler: the service returned an infeasible "
                         f"mapping (n={q.n}, m={g.n})")
        runs[-1].append(dict(sent=len(problems), found=found,
                             wall_ms=wall * 1e3,
                             tiers=[r.tier for r in res],
                             buckets=sorted({tuple(r.bucket) for r in res}),
                             host_syncs=self.stats.host_syncs - syncs,
                             results=res))
        return res

    def sim_cfg(mode, backend="cuda"):
        return SimConfig(platform=platform.CLOUD, matcher_mode=mode,
                         pso_cfg=pso.PSOConfig(**SCHED_SWARM,
                                               backend=backend),
                         window_stages=SCHED_WINDOW, validate=True)

    def simulate(backend="cuda"):
        runs.append([])
        MatcherService.match_many = match_many
        try:
            return Simulator(sim_cfg("real", backend),
                             get_scheduler("immsched")).run(sc)
        except AssertionError as e:  # check_invariants under validate=True
            fail(f"scheduler ({backend} suite): simulator invariants "
                 f"failed: {e}")
        finally:
            MatcherService.match_many = orig

    def comparable(r):
        d = dataclasses.asdict(r)
        d["matcher_stats"] = {k: v for k, v in d["matcher_stats"].items()
                              if not k.endswith("wall_s")
                              and k not in ("fe_wait_s", "epoch_backend")}
        return d

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = split_float({k: c.count for k, c in counters.items()})
    drains = runs[0]
    ms = res.matcher_stats
    if res.truncated or res.finished != res.total:
        fail(f"scheduler: truncated={res.truncated}, finished "
             f"{res.finished} of {res.total}")
    for k in SCHED_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the scheduler phase")
    # the same simulation through the plain versions on the card
    t0 = time.perf_counter()
    ref_res = simulate("ref")
    ref_wall = time.perf_counter() - t0
    if comparable(res) != comparable(ref_res):
        got, want = comparable(res), comparable(ref_res)
        diff = sorted(k for k in got if got[k] != want[k])
        diff += sorted(k for k in got["matcher_stats"]
                       if got["matcher_stats"][k]
                       != want["matcher_stats"].get(k))
        fail(f"scheduler: the cuda suite's SimResult differs from the ref "
             f"suite's in {diff}")
    if [d["sent"] for d in drains] != [d["sent"] for d in runs[1]]:
        fail("scheduler: the cuda and ref suites drained different bursts")
    for i, (dc, dr) in enumerate(zip(drains, runs[1])):
        for a, b in zip(dc["results"], dr["results"]):
            if ((a.tier, a.found, a.epochs_run)
                    != (b.tier, b.found, b.epochs_run)
                    or (a.mapping is None) != (b.mapping is None)
                    or (a.mapping is not None
                        and not (a.mapping == b.mapping).all())):
                fail(f"scheduler: drain {i} differs between the cuda and "
                     f"the ref suite")
    log(f"scheduler: cuda suite == ref suite over {len(drains)} drains "
        f"(ref run {ref_wall * 1e3:.1f} ms)")
    for run in runs:
        for d in run:
            del d["results"]
    tiers = {f"tier{i}": ms[f"sched_tier{i}_decisions"] for i in range(3)}
    walls = sorted(d["wall_ms"] for d in drains)
    line = dict(
        sched=sc.name, tasks=res.total, urgent_tasks=res.urgent_total,
        urgent_met=res.urgent_met, finished=res.finished,
        deadline_met=res.deadline_met, events=res.events,
        predicted_tier_decisions=tiers,
        service_tiers={f"tier{i}": {k: ms[f"tier{i}_{k}"] for k in
                                    ("launches", "checked", "hits")}
                       for i in range(3)},
        sim_lookups=ms["sim_lookups"],
        sim_neighbor_hits=ms["sim_neighbor_hits"],
        drains=ms["drains"], host_syncs=ms["host_syncs"],
        host_syncs_per_drain=ms["host_syncs_per_drain"],
        real_matches_sent=sum(d["sent"] for d in drains),
        real_matches_found=sum(d["found"] for d in drains),
        run_wall_ms=wall * 1e3, match_many_wall_ms=sum(walls),
        match_many_ms_min_median_max=([walls[0], statistics.median(walls),
                                       walls[-1]] if walls else None),
        cost_model_s=dict(avg_sched_time=res.avg_sched_time,
                          **{k: v for k, v in res.percentiles.items()
                             if k.startswith("sched_")}),
        ref_run_wall_ms=ref_wall * 1e3,
        launches={k: launches[k] for k in (*MAIN_KERNELS, FLOAT_EPOCH)},
        per_drain=drains)
    # measurement only: the same run once more under the profiler, for the
    # card's idle share of a simulation
    _, prof_wall, rows = profiled(simulate)
    busy = sum(r[1] for r in rows)
    line["profile"] = dict(wall_ms=prof_wall, device_busy_ms=busy,
                           idle_share=1.0 - busy / max(prof_wall, 1e-9),
                           device_launches=sum(r[2] for r in rows),
                           top=[dict(kernel=k[:60], ms=ms, calls=c)
                                for k, ms, c in rows[:6]])
    log(json.dumps(line))
    # the same scenario, analytic, through every scheduler (host only)
    for c in counters.values():
        c.reset()
    results = {name: Simulator(sim_cfg("analytic"),
                               get_scheduler(name)).run(sc)
               for name in SCHEDULERS}
    if any(c.count for c in counters.values()):
        fail("an analytic simulation launched a kernel")
    analytic = dict(speedup_table=metrics.speedup_table(results),
                    energy_efficiency=metrics.energy_efficiency(results),
                    urgent_met={k: [r.urgent_met, r.urgent_total]
                                for k, r in results.items()})
    log(json.dumps(dict(sched_analytic=sc.name, **analytic)))
    return dict(real=line, analytic=analytic, launches=launches)


def profiled(fn):
    """Run ``fn()`` once under the profiler, synchronized. Returns
    ``(profile, wall ms, [(device event, ms, count)] by time)``: the
    device-side events only (kernels, copies), since an aten op's device
    time repeats that of the kernels it launched."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((ev.key, dev / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return prof, wall * 1e3, rows


def profile_burst(pso, Qb, Gb, Mb, cfg, out_dir):
    """Device time by kernel over one ``match_batch`` of the burst, and
    the device's busy share of the synchronized wall time."""
    seeds = [SEED + 100 + b for b in range(Mb.shape[0])]
    prof, wall_ms, rows = profiled(
        lambda: pso.match_batch(Qb, Gb, Mb, cfg, streams=seeds))
    busy_ms = sum(r[1] for r in rows)
    if out_dir is not None:
        (out_dir / "profile.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40))
    return dict(summary=dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / max(wall_ms, 1e-9),
        top=[dict(kernel=k[:60], ms=ms, calls=c) for k, ms, c in rows[:8]]))


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the detailed JSON and profile")
    out_dir = ap.parse_args().out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import pso
    from repro_torch.core.matcher import (IMMSchedMatcher,
                                          collect_batch_results)
    from repro_torch.kernels import (_build, argmax_project, cases,
                                     epoch_fused, finish_fused,
                                     prune_fixpoint, pso_fitness, pso_update,
                                     ullmann_refine)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    t_all = time.time()
    detail = {}

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    detail["card"] = card

    # 2. build
    t0 = time.time()
    reports = _build.build_all()
    detail["build_s"] = time.time() - t0
    log(f"build: {len(reports)} libraries compiled in "
        f"{detail['build_s']:.2f} s")
    for name, rep in reports.items():
        regs = [l.strip() for l in rep.splitlines() if "registers" in l]
        log(f"  {name}: {'; '.join(regs)}")

    # 3. kernels against their plain versions at the main path's shapes
    reqs, tgt, bucket, Qb, Gb, Mb = build_requests()
    P, n, m = Mb.shape
    log(f"requests: {[(r['name'], r['q'].n) for r in reqs]} target "
        f"{tgt.n} engines, bucket {bucket}")
    if bucket != (56, 144):
        fail(f"bucket {bucket} is not the main path's (56, 144)")
    elite_k = pso.elite_k_for(pso.PSOConfig())
    x = cases.swarm_inputs(Qb, Gb, Mb, N, K, seed=SEED)
    errs = {k: 0.0 for k in (*KERNELS, FLOAT_EPOCH)}
    timed = {}
    for quantized, tau in ((True, 0.0), (False, 0.0), (True, 0.3),
                           (False, 0.3)):
        pairs = cases.kernel_pairs(Qb, Gb, Mb, x, quantized=quantized,
                                   gumbel_tau=tau, elite_k=elite_k)
        for name, (kern, plain) in pairs.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            key = (FLOAT_EPOCH if name == "epoch_fused" and not quantized
                   else name)
            try:
                errs[key] = max(errs[key], cases.compare(got, want))
            except AssertionError as e:
                fail(f"{name} (quantized={quantized}, tau={tau}) "
                     f"disagrees with its plain version: {e}")
            if name in BITWISE and not all(
                    torch.equal(g, w)
                    for g, w in zip(_outs(got), _outs(want))):
                fail(f"{name} (quantized={quantized}, tau={tau}) is not "
                     f"bit for bit its plain version")
            log(f"  {name} quantized={quantized} tau={tau}: agrees "
                f"(max abs err {errs[key]:.3g})")
            if tau == 0.0 and (quantized or key == FLOAT_EPOCH):
                timed[key] = (kern, plain, got)   # the main path's modes
    # the float fitness where its tiles live in device scratch
    lP, lN, ln, lm = FITNESS_LARGE
    lQ, lG, lmask = (t.cuda() for t in cases.random_problem(lP, ln, lm,
                                                             SEED))
    lS = cases.swarm_inputs(lQ, lG, lmask, lN, 1, seed=SEED)["S"]
    got = pso_fitness.edge_fitness_cuda(lS, lQ, lG)
    torch.cuda.synchronize()
    if not torch.equal(got, pso_fitness.edge_fitness_reference(lS, lQ, lG)):
        fail(f"edge_fitness at {FITNESS_LARGE} is not bit for bit its "
             f"plain version")
    log(f"  edge_fitness at {FITNESS_LARGE} (tiles in device scratch): "
        f"bit for bit")
    outs = {k: v[2] for k, v in timed.items()}
    bounds = kernel_bounds(Qb, Gb, Mb, x, outs, quantized=True,
                           elite_k=elite_k)
    bounds[FLOAT_EPOCH] = kernel_bounds(
        Qb, Gb, Mb, x, {**outs, "epoch_fused": outs[FLOAT_EPOCH]},
        quantized=False, elite_k=elite_k)["epoch_fused"]
    # one PyTorch call pair for the masked argmax: where, then argmax
    keep = Mb != 0
    neg = torch.full_like(x["S_star"], torch.finfo(torch.float32).min)

    def library_argmax():
        return [torch.argmax(torch.where(keep[p], x["S_star"][p],
                                         neg[p]).reshape(-1))
                for p in range(P)]
    library = {"masked_argmax": library_argmax}
    records = {}
    for name, (kern, plain, _) in timed.items():
        calls = P if name in cases.PER_PROBLEM else 1   # ms per call
        # the median of 5 runs of 10 calls; a library call pair is timed
        # in turns with the kernel, so that both see the same host
        runs = {}
        for _ in range(5):
            for key, fn in (("ms", kern), ("library_ms", library.get(name))):
                if fn is not None:
                    runs.setdefault(key, []).append(
                        cuda_ms(fn, reps=10, warm=2) / calls)
        ms = statistics.median(runs["ms"])
        plain_ms = cuda_ms(plain, reps=2, warm=1) / calls
        bms, by = bounds[name]
        # device time alone (kernels and the wrapper's copies): where it is
        # far below ms, the host's dispatch sets the pace
        device_ms = sum(r[1] for r in profiled(kern)[2]) / calls
        records[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=(statistics.median(runs["library_ms"])
                        if name in library else None),
            device_ms=device_ms)
        if name in library:
            records[name]["library_device_ms"] = sum(
                r[1] for r in profiled(library[name])[2]) / calls
    for name, rec in records.items():
        log(json.dumps(dict(kernel=name, **rec, max_abs_err=errs[name])))

    # 4. the main path
    counters = {"prune_fixpoint": prune_fixpoint.launches,
                "edge_fitness": pso_fitness.launches,
                "edge_fitness_quantized": pso_fitness.launches_quantized,
                "epoch_fused": epoch_fused.launches,
                FLOAT_EPOCH: epoch_fused.launches_float,
                "epoch_finish": finish_fused.launches,
                "pso_update": pso_update.launches,
                "ullmann_refine_step": ullmann_refine.launches,
                "greedy_project": argmax_project.launches_greedy,
                "masked_argmax": argmax_project.launches_argmax}
    for c in counters.values():
        c.reset()
    cfg = pso.PSOConfig(quantized=True, early_exit=True)
    torch.cuda.synchronize()
    t0 = time.time()
    outs = pso.match_batch(Qb, Gb, Mb, cfg,
                           streams=[SEED + b for b in range(P)])
    torch.cuda.synchronize()
    t_match = time.time() - t0
    results = collect_batch_results(
        outs, P, orders=[r["order"] for r in reqs],
        crops=[(r["q"].n, tgt.n) for r in reqs])
    found = 0
    for r, res, b in zip(reqs, results, range(P)):
        if res.found:
            found += 1
            q_orig = r["q"].adj[np.ix_(np.argsort(r["order"]),
                                      np.argsort(r["order"]))]
            if not feasible_np(res.mapping, q_orig, tgt.adj):
                fail(f"{r['name']}: found mapping is infeasible")
        log(f"  {r['name']:13s} n={r['q'].n:3d} found={res.found} "
            f"epochs_run={res.epochs_run} prune_sweeps={res.prune_sweeps}")
    log(f"match_batch: {found}/{P} found, host_syncs={outs['host_syncs']}, "
        f"wall {t_match * 1e3:.1f} ms ({t_match * 1e3 / P:.1f} ms "
        f"per decision)")
    carry = (outs["S_star"], outs["f_star"], outs["S_bar"])
    torch.cuda.synchronize()
    t0 = time.time()
    rv = pso.revalidate_batch(Qb, Gb, Mb, cfg, carry)
    torch.cuda.synchronize()
    t_reval = time.time() - t0
    ok = rv["ok"].cpu().numpy()
    for b in np.where(ok)[0]:
        if not feasible_np(rv["mapping"][b].cpu().numpy(),
                           Qb[b].cpu().numpy(), Gb[b].cpu().numpy()):
            fail(f"revalidated hit {b} is infeasible")
    log(f"revalidate_batch (Tier 0): {int(ok.sum())}/{P} hits, wall "
        f"{t_reval * 1e3:.1f} ms")
    fcfg = pso.PSOConfig()
    unet = reqs[WORKLOADS.index("unet")]
    torch.cuda.synchronize()
    t0 = time.time()
    res = IMMSchedMatcher(fcfg).match(unet["q"], tgt, stream=SEED)
    torch.cuda.synchronize()
    t_single = time.time() - t0
    if res.found and not feasible_np(res.mapping, unet["q"].adj, tgt.adj):
        fail("float-config match returned an infeasible mapping")
    log(f"IMMSchedMatcher.match (float, unet): found={res.found} "
        f"epochs_run={res.epochs_run} prune_sweeps={res.prune_sweeps} "
        f"wall {t_single * 1e3:.1f} ms")
    launches = split_float({k: counters[k].count
                            for k in (*MAIN_KERNELS, FLOAT_EPOCH)})
    main_calls = split_float({k: counters[k].calls
                              for k in (*MAIN_KERNELS, FLOAT_EPOCH)})
    log(f"launches on the main path: {launches} in wrapper calls "
        f"{main_calls}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if found == 0:
        fail("the main path found no mapping at all")
    detail["main_path"] = dict(
        found=found, epochs_run=[r.epochs_run for r in results],
        prune_sweeps=[r.prune_sweeps for r in results],
        host_syncs=outs["host_syncs"], match_batch_s=t_match,
        revalidate_s=t_reval, reval_hits=int(ok.sum()),
        single_match_s=t_single, single_found=res.found,
        launches=launches, calls=main_calls)

    # 4b. the matcher service: its drains at the burst's full width
    detail["service"] = service_phase(pso, reqs, counters, out_dir)
    service_launches = detail["service"]["launches"]

    # 4c. the scheduler: a real-mode simulation through the service
    detail["sched"] = sched_phase(pso, counters)
    sched_launches = detail["sched"]["launches"]

    # 5. the split (pre-fusion) epoch against the fused one
    detail["split_epoch"] = split_phase(pso, Qb, Gb, Mb, x, counters)
    split_launches = detail["split_epoch"]["launches"]

    # 6. path parity: cuda suite against ref suite, same draws
    small = pso.PSOConfig(num_particles=16, epochs=1, inner_steps=4,
                          quantized=True)
    d = {"init": torch.rand((1, P, 16, n, m), device="cuda") * 0.95 + 0.05,
         "steps": torch.rand((1, P, 4, 16, 3), device="cuda")}
    oc = pso.match_batch(Qb, Gb, Mb, small.replace(backend="cuda"), draws=d)
    orf = pso.match_batch(Qb, Gb, Mb, small.replace(backend="ref"), draws=d)
    for k in ("mappings", "feasible", "prune_sweeps", "epochs_run"):
        if not torch.equal(oc[k], orf[k]):
            fail(f"path parity: {k} differs between cuda and ref suites")
    torch.testing.assert_close(oc["f_star"], orf["f_star"], rtol=1e-5,
                               atol=1e-4)
    log("path parity: cuda suite == ref suite on the same draws")

    # 7. where the burst's time goes: one match_batch under the profiler
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    detail["profile"] = profile_burst(pso, Qb, Gb, Mb, cfg, out_dir)
    log(f"profile: {json.dumps(detail['profile']['summary'])}")

    kern = []
    split_calls = detail["split_epoch"]["calls"]
    rows = [(k, *v) for k, v in KERNELS.items()]
    rows.insert(4, (FLOAT_EPOCH, *KERNELS["epoch_fused"]))
    for name, src, replaces in rows:
        rec = records[name]
        detail.setdefault("device_ms", {})[name] = rec["device_ms"]
        n_launch = launches.get(name, split_launches.get(name))
        n_calls = main_calls.get(name, split_calls.get(name))
        kern.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=n_launch,
                         service_launches=service_launches.get(name),
                         sched_launches=sched_launches.get(name),
                         launches_per_call=(n_launch / n_calls
                                            if n_calls else None),
                         max_abs_err=errs[name], ms=rec["ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         bound_by=rec["bound_by"],
                         library_ms=rec["library_ms"]))
    detail["kernels"] = kern
    detail["total_s"] = time.time() - t_all
    if out_dir is not None:
        (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"total {detail['total_s']:.1f} s")
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
