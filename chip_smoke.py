#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card (name and power limit from nvidia-smi), torch and CUDA;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (timed);
  3. kernels: at the main path's shapes (P = 8 problems, N = 64
     particles, K = 12 steps, bucket (56, 144)) each of the five ported
     entry points against its plain PyTorch version on the same inputs,
     float and quantized, τ = 0 and τ > 0: integers bit for bit, floats
     within rtol 1e-5 / atol 1e-4; both timed with CUDA events;
  4. the main path: 8 scheduling requests built as the IMMSched
     scheduler builds them (zoo workloads at window_stages=8 on the Cloud
     platform with a seeded set of 96 free engines, relabelled and padded
     to one bucket), solved by ``match_batch`` (quantized, early exit),
     re-validated by ``revalidate_batch`` (Tier 0), plus one float-config
     ``IMMSchedMatcher.match``; every returned mapping must be feasible
     and every kernel must have been launched;
  5. path parity: the same burst at a reduced swarm through the ``cuda``
     and the ``ref`` suite on the same draws must give the same first
     epoch;
  6. profile: device time by kernel over one more ``match_batch`` of the
     burst, and the device's idle share of its wall time.

The second-to-last line is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``. With ``--out DIR`` the details (a
JSON record and the profiler's table) are also written to DIR.
"""
import argparse
import json
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
    "edge_fitness_quantized": ("src/repro_torch/csrc/pso_fitness.cu",
                               "src/repro/kernels/pso_fitness.py:132"),
    "epoch_fused": ("src/repro_torch/csrc/epoch_fused.cu",
                    "src/repro/kernels/epoch_fused.py:251"),
    "epoch_finish": ("src/repro_torch/csrc/finish_fused.cu",
                     "src/repro/kernels/finish_fused.py:373"),
}


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

def build_requests():
    from repro_torch.accel import platform, target_graph
    from repro_torch.core import graphs, preemptible_dag as pdag
    from repro_torch.workloads import zoo
    plat = platform.CLOUD
    free = np.zeros(plat.engines, dtype=bool)
    free[np.random.default_rng(FREE_SEED).choice(plat.engines, N_FREE,
                                                 replace=False)] = True
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
    return b


def profile_burst(pso, Qb, Gb, Mb, cfg, out_dir):
    """Device time by kernel over one ``match_batch`` of the burst, and
    the device's busy share of the synchronized wall time."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pso.match_batch(Qb, Gb, Mb, cfg, generator=gen)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's device
        # time repeats that of the kernels it launched
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((ev.key, dev / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if out_dir is not None:
        (out_dir / "profile.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40))
    return dict(summary=dict(
        wall_ms=wall * 1e3, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / max(wall * 1e3, 1e-9),
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
    from repro_torch.kernels import (_build, cases, epoch_fused,
                                     finish_fused, prune_fixpoint,
                                     pso_fitness)
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
    errs = {k: 0.0 for k in KERNELS}
    timed = {}
    for quantized, tau in ((True, 0.0), (False, 0.0), (True, 0.3),
                           (False, 0.3)):
        pairs = cases.kernel_pairs(Qb, Gb, Mb, x, quantized=quantized,
                                   gumbel_tau=tau, elite_k=elite_k)
        for name, (kern, plain) in pairs.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            try:
                errs[name] = max(errs[name], cases.compare(got, want))
            except AssertionError as e:
                fail(f"{name} (quantized={quantized}, tau={tau}) "
                     f"disagrees with its plain version: {e}")
            log(f"  {name} quantized={quantized} tau={tau}: agrees "
                f"(max abs err {errs[name]:.3g})")
            if quantized and tau == 0.0:     # the main path's mode
                timed[name] = (kern, plain, got)
    outs = {k: v[2] for k, v in timed.items()}
    bounds = kernel_bounds(Qb, Gb, Mb, x, outs, quantized=True,
                           elite_k=elite_k)
    records = {}
    for name, (kern, plain, _) in timed.items():
        ms = cuda_ms(kern, reps=10, warm=2)
        plain_ms = cuda_ms(plain, reps=2, warm=1)
        bms, by = bounds[name]
        records[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by)
        log(json.dumps(dict(kernel=name, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by,
                            max_abs_err=errs[name])))

    # 4. the main path
    counters = {"prune_fixpoint": [prune_fixpoint.launches],
                "edge_fitness": [pso_fitness.launches],
                "edge_fitness_quantized": [pso_fitness.launches_quantized],
                "epoch_fused": [epoch_fused.launches],
                "epoch_finish": [finish_fused.launches]}
    for cs in counters.values():
        for c in cs:
            c.reset()
    cfg = pso.PSOConfig(quantized=True, early_exit=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.time()
    outs = pso.match_batch(Qb, Gb, Mb, cfg, generator=gen)
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
    res = IMMSchedMatcher(fcfg).match(
        unet["q"], tgt, generator=torch.Generator(
            device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    t_single = time.time() - t0
    if res.found and not feasible_np(res.mapping, unet["q"].adj, tgt.adj):
        fail("float-config match returned an infeasible mapping")
    log(f"IMMSchedMatcher.match (float, unet): found={res.found} "
        f"epochs_run={res.epochs_run} prune_sweeps={res.prune_sweeps} "
        f"wall {t_single * 1e3:.1f} ms")
    launches = {k: sum(c.count for c in cs) for k, cs in counters.items()}
    log(f"launches on the main path: {launches}")
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
        launches=launches)

    # 5. path parity: cuda suite against ref suite, same draws
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

    # 6. where the burst's time goes: one match_batch under the profiler
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    detail["profile"] = profile_burst(pso, Qb, Gb, Mb, cfg, out_dir)
    log(f"profile: {json.dumps(detail['profile']['summary'])}")

    kern = []
    for name, (src, replaces) in KERNELS.items():
        rec = records[name]
        kern.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=errs[name], ms=rec["ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         bound_by=rec["bound_by"], library_ms=None))
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
