"""Online matcher service under a stream of unpredictable arrivals.

    PYTHONPATH=src python -m repro_torch.examples.online_service \
        [--device cpu]

Simulates the scheduling hot path: DNN windows (query DAGs) arriving
against a changing free-engine set on the Edge array, served through the
``MatcherService``. The first arrival of each shape class builds its
bucket; every repeat hits the shape cache, warm-starts from the previous
consensus S̄/S*, and early-exits as soon as a feasible mapping clears the
bound. Runs on the card unless given ``--device cpu``; a request's key
is its seed (its index in the stream).
"""
import argparse
import time

import numpy as np

from repro_torch.accel.platform import EDGE
from repro_torch.accel.target_graph import (free_engine_graph,
                                            free_engine_signature)
from repro_torch.core import preemptible_dag
from repro_torch.core.pso import PSOConfig
from repro_torch.core.service import MatcherService
from repro_torch.workloads.zoo import get_workload


def main(argv=None):
    """Serve 12 seeded arrivals; returns one record per arrival (name,
    busy_half, query, target, bucket, compiled, warm, epochs, found,
    mapping) and prints the reference example's table."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    cap = EDGE.engine_tile_capacity_macs()
    windows = {}
    for name in ("mobilenetv2", "resnet50"):
        pd = preemptible_dag.build_preemptible_dag(
            [(0, get_workload(name), 0)], tile_capacity_macs=cap,
            window_stages=2)
        windows[name] = pd.graph
        print(f"{name}: window of {pd.graph.n} tiles")

    # two platform states: all engines free / half the array busy
    free_all = [True] * EDGE.engines
    free_half = [e % 2 == 0 for e in range(EDGE.engines)]

    svc = MatcherService(PSOConfig(num_particles=32, epochs=4,
                                   inner_steps=8), device=device)
    rng = np.random.default_rng(0)
    arrivals = [(rng.choice(list(windows)), rng.random() < 0.5)
                for _ in range(12)]

    print(f"\n{'arrival':<22}{'bucket':<12}{'compiled':<10}"
          f"{'warm':<7}{'epochs':<8}latency")
    records = []
    for i, (name, busy_half) in enumerate(arrivals):
        free = free_half if busy_half else free_all
        q = windows[name]
        tgt = free_engine_graph(EDGE, free)
        if q.n > tgt.n:             # window larger than the free array
            keep = np.arange(tgt.n)
            q = type(q)(adj=q.adj[np.ix_(keep, keep)], types=q.types[keep],
                        weights=q.weights[keep])
        t0 = time.perf_counter()
        res = svc.match(q, tgt, key=i,
                        workload_key=(name, free_engine_signature(free)))
        dt = time.perf_counter() - t0
        state = "half-busy" if busy_half else "idle"
        print(f"{name + '/' + state:<22}{str(res.bucket):<12}"
              f"{'hit' if res.compile_cache_hit else 'COMPILE':<10}"
              f"{'yes' if res.warm_hit else 'no':<7}"
              f"{res.epochs_run:<8}{dt * 1e3:9.2f} ms"
              + ("" if res.found else "   (infeasible)"))
        records.append(dict(
            name=str(name), busy_half=bool(busy_half), query=q, target=tgt,
            bucket=tuple(res.bucket), compiled=not res.compile_cache_hit,
            warm=bool(res.warm_hit), epochs=int(res.epochs_run),
            found=bool(res.found),
            mapping=None if res.mapping is None
            else np.asarray(res.mapping)))

    s = svc.stats_dict()
    print(f"\ncompile cache: {s['compile_cache_hits']}/{s['calls']} hits, "
          f"warm starts: {s['warm_hits']}/{s['calls']}, "
          f"epochs saved by early exit: {s['epochs_saved']}/"
          f"{s['epochs_budgeted']}")
    return records


if __name__ == "__main__":
    main()
