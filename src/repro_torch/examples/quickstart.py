"""Quickstart: IMMSched's parallel PSO-Ullmann subgraph matcher in 30 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Plants an 8-tile workload DAG inside a 16-engine array and recovers a
feasible mapping with the quantized (uint8, integer-accumulate) matcher —
the computation the paper runs on the accelerator's MAC datapath. Runs
on the card unless given ``--device cpu``.
"""
import argparse

import numpy as np

from repro_torch.core import graphs
from repro_torch.core.matcher import IMMSchedMatcher
from repro_torch.core.pso import PSOConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    rng = np.random.default_rng(0)
    # a workload window: random 8-tile DAG
    query = graphs.random_dag(rng, 8, edge_prob=0.35)
    # an engine array that provably contains it
    target = graphs.embed_query_in_target(rng, query, 16)

    cfg = PSOConfig(num_particles=48, epochs=4, inner_steps=10,
                    quantized=True)
    result = IMMSchedMatcher(cfg, device=device).match(query, target)

    assert result.found, "matcher failed on a feasible instance"
    M = np.asarray(result.mapping, dtype=int)
    print("feasible mappings found:", result.feasible_count)
    print("tile -> engine:", {i: int(np.argmax(M[i])) for i in range(M.shape[0])})
    covered = M @ target.adj.astype(int) @ M.T
    print("all query edges preserved:", bool((covered >= query.adj).all()))
    print("global best fitness f* =", result.f_star)


if __name__ == "__main__":
    main()
