"""Fault tolerance and elasticity for the serving runtime.

Port of the JAX package's ``runtime/ft.py``. Three mechanisms:

  * **StepWatchdog** — EWMA + k·σ step-time anomaly detector; flags
    straggling hosts so the launcher can exclude them at the next
    checkpoint boundary.
  * **elastic mesh rebuild** — derive the mesh from the *live* device
    set (the largest (pods, data, model) factorization that keeps the
    model axis), restore the checkpoint on it
    (``CheckpointManager.restore(shardings=...)``) and set the data
    cursor; nothing in the state is tied to the old device count.
  * **engine re-matching** (the paper's own mechanism doubling as fault
    tolerance) — when engines fail mid-run on the accelerator, drop them
    from the target graph G and re-run the IMMSched matcher to remap the
    workload's tile window onto the surviving engines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class StepWatchdog:
    alpha: float = 0.1            # EWMA smoothing
    k_sigma: float = 3.0
    warmup: int = 10
    mean: float = 0.0
    var: float = 0.0
    count: int = 0

    def observe(self, step_time: float) -> bool:
        """Returns True if this step is a straggler anomaly."""
        self.count += 1
        if self.count <= self.warmup:
            d = step_time - self.mean
            self.mean += d / self.count
            self.var += d * (step_time - self.mean)
            return False
        std = math.sqrt(max(self.var / max(self.count - 1, 1), 1e-12))
        is_straggler = step_time > self.mean + self.k_sigma * std
        d = step_time - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


def elastic_mesh_shape(num_devices: int, model_parallel: int = 16,
                       multi_pod_threshold: int = 512):
    """Largest mesh from the live device set, preserving the tensor axis.

    Returns (shape, axis_names). Drops stragglers by simply being called
    with the smaller device count — data parallel shrinks, the model axis
    (which the checkpointed layouts depend on) is preserved.
    """
    if num_devices < model_parallel:
        raise ValueError(f"{num_devices} devices cannot keep a model axis "
                         f"of {model_parallel}")
    usable = (num_devices // model_parallel) * model_parallel
    data = usable // model_parallel
    if usable >= multi_pod_threshold and data % 2 == 0:
        return (2, data // 2, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def surviving_engine_mask(num_engines: int,
                          failed: Sequence[int]) -> List[bool]:
    failed_set = set(failed)
    return [e not in failed_set for e in range(num_engines)]


def failure_problem(platform, running_workload, failed_engines):
    """The re-matching problem after ``failed_engines`` fail: the
    workload's tile window (4 stages; cut to its earliest-stage tiles
    when it has more tiles than engines survive) and the surviving
    engine graph. Returns ``(query, target)``."""
    from repro_torch.accel.target_graph import free_engine_graph
    from repro_torch.core import preemptible_dag

    mask = surviving_engine_mask(platform.engines, failed_engines)
    target = free_engine_graph(platform, mask)
    cap = platform.engine_tile_capacity_macs()
    pdag = preemptible_dag.build_preemptible_dag(
        [(0, running_workload, 0)], tile_capacity_macs=cap,
        window_stages=4)
    q = pdag.graph
    if q.n > target.n:
        keep = np.sort(np.argsort([t.stage for t in pdag.tiles])[:target.n])
        q = type(q)(adj=q.adj[np.ix_(keep, keep)], types=q.types[keep],
                    weights=q.weights[keep])
    return q, target


def remap_on_failure(platform, running_workload, failed_engines,
                     matcher=None, device="cuda"):
    """Re-match a running workload's tile window onto the surviving
    engines (the paper's subgraph matcher as the fault-tolerance
    mechanism), with ``matcher`` or a default ``IMMSchedMatcher`` on
    ``device``. Returns (mapping or None, surviving target graph)."""
    from repro_torch.core.matcher import IMMSchedMatcher

    q, target = failure_problem(platform, running_workload, failed_engines)
    matcher = matcher or IMMSchedMatcher(device=device)
    res = matcher.match(q, target)
    return (res.mapping if res.found else None), target
