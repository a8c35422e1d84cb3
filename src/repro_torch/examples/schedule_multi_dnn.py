"""Schedule two of the framework's own LM architectures side by side on
the Cloud engine array: lower both configs to tile DAGs (Layer
Concatenate-and-Split + DAG-to-Pipeline), match the merged preemptible
DAG with the parallel matcher, and emit and validate the ILP schedule
tensors X ∈ {0,1}^{D×I×N×T×P}, Y ∈ {0,1}^{D×I×K×T×L}.

    PYTHONPATH=src python -m repro_torch.examples.schedule_multi_dnn \
        [--device cpu]

The matcher runs on the card unless given ``--device cpu``.
"""
import argparse

import numpy as np

from repro_torch.accel.platform import CLOUD
from repro_torch.accel.target_graph import free_engine_graph
from repro_torch.configs import get_config
from repro_torch.core import ilp, preemptible_dag
from repro_torch.core.matcher import IMMSchedMatcher
from repro_torch.core.pso import PSOConfig
from repro_torch.workloads.zoo import lm_workload_from_config


def main(argv=None):
    """Returns ``(pdag, match result, schedule tensors)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    wl_a = lm_workload_from_config(get_config("qwen2.5-3b"), block_group=2)
    wl_b = lm_workload_from_config(get_config("llama3-8b"), block_group=2)
    cap = CLOUD.engine_tile_capacity_macs()
    pdag = preemptible_dag.build_preemptible_dag(
        [(0, wl_a, 0), (1, wl_b, 0)], tile_capacity_macs=cap,
        window_stages=3)
    print(f"merged preemptible DAG: {pdag.n} tiles "
          f"({ {k: len(v) for k, v in pdag.task_tiles.items()} } per task)")

    target = free_engine_graph(CLOUD, [True] * CLOUD.engines)
    cfg = PSOConfig(num_particles=64, epochs=4, inner_steps=10)
    res = IMMSchedMatcher(cfg, device=device).match(pdag.graph, target)
    assert res.found, "no feasible co-schedule found"
    print(f"feasible co-schedules found: {res.feasible_count}")

    st = ilp.build_schedule_tensors(pdag, np.asarray(res.mapping), CLOUD)
    errs = ilp.validate_schedule(st, pdag)
    print(f"ILP tensors: X{st.X.shape} Y{st.Y.shape} "
          f"violations: {errs or 'none'}")
    busy = st.X.sum(axis=(0, 1, 3, 4)) > 0
    print(f"engines used: {int(busy.sum())}/{CLOUD.engines}")
    return pdag, res, st


if __name__ == "__main__":
    main()
