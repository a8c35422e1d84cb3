"""ILP scheduling-tensor construction and validation (paper §3.1).

The paper formalizes multi-DNN scheduling with two binary tensors

    X ∈ {0,1}^{D×I×N×T×P}   compute mapping
    Y ∈ {0,1}^{D×I×K×T×L}   communication mapping

with D tasks, I tiles/task, N engines, T timesteps, P engine partitions,
K max NoC hops, L directed links. A subgraph matching M̂ (tile → engine)
plus the tile DAG's pipeline stages induce (X, Y); this module builds them
and checks the ILP constraints — the scheduler's *commit* step runs these
checks before activating a new mapping.

Numpy copy of the JAX package's ``core/ilp.py``; the port keeps its own
copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.accel.platform import Platform
from repro_torch.core.preemptible_dag import PreemptibleDAG


def _links(platform: Platform) -> Dict[Tuple[int, int], int]:
    """Directed NoC links of the engine mesh → link ids."""
    links: Dict[Tuple[int, int], int] = {}
    R, C = platform.noc_rows, platform.noc_cols

    def idx(r, c):
        return r * C + c

    for r in range(R):
        for c in range(C):
            for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < R and 0 <= cc < C:
                    links.setdefault((idx(r, c), idx(rr, cc)), len(links))
    return links


def xy_route(platform: Platform, src: int, dst: int) -> List[Tuple[int, int]]:
    """Deterministic XY routing on the engine mesh."""
    C = platform.noc_cols
    r0, c0 = divmod(src, C)
    r1, c1 = divmod(dst, C)
    hops = []
    r, c = r0, c0
    while c != c1:
        c2 = c + (1 if c1 > c else -1)
        hops.append((r * C + c, r * C + c2))
        c = c2
    while r != r1:
        r2 = r + (1 if r1 > r else -1)
        hops.append((r * C + c, r2 * C + c))
        r = r2
    return hops


@dataclasses.dataclass
class ScheduleTensors:
    X: np.ndarray            # (D, I, N, T, P) uint8
    Y: np.ndarray            # (D, I, K, T, L) uint8
    task_ids: List[int]
    link_ids: Dict[Tuple[int, int], int]


def build_schedule_tensors(pdag: PreemptibleDAG, mapping: np.ndarray,
                           platform: Platform,
                           partitions: int = 1) -> ScheduleTensors:
    """mapping: (n, m) assignment over *free-engine* target graph whose
    weights carry original engine ids."""
    tiles = pdag.tiles
    n = len(tiles)
    task_ids = sorted({t.task_id for t in tiles})
    tindex = {tid: d for d, tid in enumerate(task_ids)}
    D = len(task_ids)
    I = max(sum(1 for t in tiles if t.task_id == tid) for tid in task_ids)
    N = platform.engines
    T = max(t.stage for t in tiles) + 1 if tiles else 1
    links = _links(platform)
    L = len(links)

    # per-task tile index
    local_idx: Dict[int, int] = {}
    counters = {tid: 0 for tid in task_ids}
    for gi, t in enumerate(tiles):
        local_idx[gi] = counters[t.task_id]
        counters[t.task_id] += 1

    engine_of = {}
    for gi in range(n):
        js = np.where(mapping[gi])[0]
        if len(js):
            engine_of[gi] = int(js[0])

    K = platform.noc_rows + platform.noc_cols  # max XY hops
    X = np.zeros((D, I, N, T, partitions), dtype=np.uint8)
    Y = np.zeros((D, I, K, T, L), dtype=np.uint8)

    adj = pdag.graph.adj
    for gi, tile in enumerate(tiles):
        if gi not in engine_of:
            continue
        d, i = tindex[tile.task_id], local_idx[gi]
        X[d, i, engine_of[gi], tile.stage, 0] = 1
        # communications to consumers (next stages)
        for gj in np.where(adj[gi])[0]:
            if int(gj) not in engine_of:
                continue
            route = xy_route(platform, engine_of[gi], engine_of[int(gj)])
            for k, hop in enumerate(route):
                Y[d, i, k, tile.stage, links[hop]] = 1
    return ScheduleTensors(X=X, Y=Y, task_ids=task_ids, link_ids=links)


def validate_schedule(st: ScheduleTensors, pdag: PreemptibleDAG,
                      link_capacity: int = 4) -> List[str]:
    """Check the ILP constraints; returns a list of violation strings
    (empty = valid schedule)."""
    errs = []
    X, Y = st.X, st.Y
    # (1) each mapped tile occupies exactly one (engine, partition, time)
    per_tile = X.sum(axis=(2, 3, 4))
    if (per_tile > 1).any():
        errs.append("tile multi-assigned")
    # (2) engine occupancy: ≤ 1 tile per (engine, timestep, partition)
    occ = X.sum(axis=(0, 1))
    if (occ > 1).any():
        errs.append("engine over-subscribed")
    # (3) link capacity per timestep
    load = Y.sum(axis=(0, 1, 2))
    if (load > link_capacity).any():
        errs.append("link over capacity")
    # (4) precedence: consumer stage strictly after producer stage unless
    #     co-located (cascaded within the engine)
    tiles = pdag.tiles
    adj = pdag.graph.adj
    eng = {}
    stage = {}
    # recompute engine/stage from X directly, re-deriving local tile indices
    counters = {}
    for gi, t in enumerate(tiles):
        d = st.task_ids.index(t.task_id)
        i = counters.get(t.task_id, 0)
        counters[t.task_id] = i + 1
        loc = np.argwhere(X[d, i])
        if len(loc):
            eng[gi] = int(loc[0][0])
            stage[gi] = int(loc[0][1])
    for gi in range(len(tiles)):
        for gj in np.where(adj[gi])[0]:
            gj = int(gj)
            if gi in stage and gj in stage:
                if stage[gj] < stage[gi]:
                    errs.append(f"precedence violated {gi}->{gj}")
                # same-stage deps are split-sibling chains: wave-pipelined
                # within the stage, legal because the matcher guarantees
                # every Q-edge maps onto a NoC link (feasibility check)
    return errs
