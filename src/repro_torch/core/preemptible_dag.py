"""Preemptible-DAG construction: DAG-to-Pipeline + Layer Concatenate-and-Split.

Following the paper (§3.1), the query graph handed to the matcher is built
from the live multi-DNN workload in three steps:

  1. **DAG-to-Pipeline** (ReMap): the layer DAG of each task is levelled into
     pipeline stages by longest-path depth; the scheduler only matches a
     *window* of the next few stages (the preemptible frontier), which keeps
     the query size bounded and is what makes interruption cheap — tiles
     beyond the window haven't been committed to engines yet.
  2. **Layer Concatenate** (IsoSched): cheap bandwidth-bound layers
     (norm/activation/elementwise) are fused into their producer tile so the
     query contains only engine-occupying vertices.
  3. **Layer Split** (IsoSched): a layer whose work exceeds one engine's
     tile capacity is split into ⌈work/capacity⌉ parallel tile vertices
     (they inherit the layer's in/out edges; no edges between siblings).

The output is a ``graphs.Graph`` whose vertices are *tiles* with compute
types + MAC weights, plus bookkeeping mapping tiles back to (task, layer).

Numpy copy of the JAX package's ``core/preemptible_dag.py``; the port keeps its own
copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import graphs
from repro_torch.workloads.layers import LayerKind, LayerSpec, WorkloadGraph

# Layer kinds fused into their producer by Layer-Concatenate.
_FUSABLE = {LayerKind.NORM, LayerKind.ACT, LayerKind.ELEMENTWISE}

_KIND_TO_TYPE = {
    LayerKind.CONV: graphs.TYPE_MAC,
    LayerKind.MATMUL: graphs.TYPE_MAC,
    LayerKind.ATTN: graphs.TYPE_MAC,
    LayerKind.MOE: graphs.TYPE_MAC,
    LayerKind.POOL: graphs.TYPE_REDUCE,
    LayerKind.REDUCE: graphs.TYPE_REDUCE,
    LayerKind.NORM: graphs.TYPE_VECTOR,
    LayerKind.ACT: graphs.TYPE_VECTOR,
    LayerKind.ELEMENTWISE: graphs.TYPE_VECTOR,
    LayerKind.EMBED: graphs.TYPE_MAC,
    LayerKind.SSM: graphs.TYPE_MAC,
}


@dataclasses.dataclass
class Tile:
    task_id: int
    layer_idx: int
    split_idx: int
    kind: LayerKind
    macs: float              # work in MACs
    bytes_moved: float       # activation traffic this tile emits
    stage: int               # pipeline stage (DAG-to-Pipeline level)


@dataclasses.dataclass
class PreemptibleDAG:
    graph: graphs.Graph
    tiles: List[Tile]
    # index ranges per task for victim accounting
    task_tiles: Dict[int, List[int]]

    @property
    def n(self) -> int:
        return self.graph.n


def _pipeline_stages(wg: WorkloadGraph) -> np.ndarray:
    """Longest-path level per layer (DAG-to-Pipeline)."""
    n = len(wg.layers)
    adj = wg.adjacency()
    order = graphs._topo_order(adj)
    level = np.zeros(n, dtype=np.int64)
    for v in order:
        preds = np.where(adj[:, v])[0]
        if len(preds):
            level[v] = level[preds].max() + 1
    return level


def _concatenate(wg: WorkloadGraph):
    """Layer-Concatenate: fuse fusable layers into their (single) producer.

    Returns (keep_list, contracted adjacency over kept layers). A fusable
    layer with multiple producers is kept (fusion would duplicate work).
    """
    n = len(wg.layers)
    adj = wg.adjacency().astype(bool)
    parent = np.arange(n)
    for v in range(n):
        preds = np.where(adj[:, v])[0]
        if wg.layers[v].kind in _FUSABLE and len(preds) == 1:
            parent[v] = preds[0]

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    roots = sorted({find(v) for v in range(n)})
    root_idx = {r: i for i, r in enumerate(roots)}
    k = len(roots)
    cadj = np.zeros((k, k), dtype=np.uint8)
    extra_macs = np.zeros(k)
    extra_bytes = np.zeros(k)
    for v in range(n):
        r = find(v)
        if v != r:
            extra_macs[root_idx[r]] += wg.layers[v].macs
            extra_bytes[root_idx[r]] += wg.layers[v].bytes_moved
    for u in range(n):
        for v in np.where(adj[u])[0]:
            ru, rv = find(u), find(int(v))
            if ru != rv:
                cadj[root_idx[ru], root_idx[rv]] = 1
    return roots, cadj, extra_macs, extra_bytes


def build_preemptible_dag(
        tasks: Sequence[Tuple[int, WorkloadGraph, int]],
        tile_capacity_macs: float,
        window_stages: int = 4,
        max_split: int = 8) -> PreemptibleDAG:
    """Build the query DAG for the matcher.

    tasks: sequence of (task_id, workload graph, progress_stage) — only
    stages in [progress, progress + window) contribute tiles.
    tile_capacity_macs: one engine-tile's MAC budget (Layer-Split threshold).
    """
    all_tiles: List[Tile] = []
    edges: List[Tuple[int, int]] = []
    task_tiles: Dict[int, List[int]] = {}

    for task_id, wg, progress in tasks:
        roots, cadj, extra_macs, extra_bytes = _concatenate(wg)
        levels_full = _pipeline_stages(wg)
        levels = levels_full[roots]
        # compress levels to consecutive stage ids
        uniq = np.unique(levels)
        stage_of = {int(l): i for i, l in enumerate(uniq)}
        lo, hi = progress, progress + window_stages

        layer_to_tiles: Dict[int, List[int]] = {}
        for li, root in enumerate(roots):
            st = stage_of[int(levels[li])]
            if not (lo <= st < hi):
                continue
            spec = wg.layers[root]
            macs = spec.macs + extra_macs[li]
            nbytes = spec.bytes_moved + extra_bytes[li]
            nsplit = int(np.clip(np.ceil(macs / tile_capacity_macs),
                                 1, max_split))
            ids = []
            for s in range(nsplit):
                tid = len(all_tiles)
                all_tiles.append(Tile(task_id=task_id, layer_idx=root,
                                      split_idx=s, kind=spec.kind,
                                      macs=macs / nsplit,
                                      bytes_moved=nbytes / nsplit,
                                      stage=st))
                ids.append(tid)
                task_tiles.setdefault(task_id, []).append(tid)
            # split siblings form a reduction/broadcast *chain* (partials
            # accumulate hop-by-hop over the NoC) — an all-to-all sibling
            # pattern would demand in/out-degree = split factor, which no
            # degree-4 engine mesh can embed
            for a, b in zip(ids[:-1], ids[1:]):
                edges.append((a, b))
            layer_to_tiles[li] = ids

        for u in range(len(roots)):
            for v in np.where(cadj[u])[0]:
                if u in layer_to_tiles and int(v) in layer_to_tiles:
                    # single bridge: end of the producer chain feeds the
                    # head of the consumer chain (degree ≤ 3 everywhere)
                    edges.append((layer_to_tiles[u][-1],
                                  layer_to_tiles[int(v)][0]))

    n = len(all_tiles)
    adj = np.zeros((n, n), dtype=np.uint8)
    for a, b in edges:
        adj[a, b] = 1
    adj = _cap_degrees(adj, cap=3)
    types = np.array([_KIND_TO_TYPE[t.kind] for t in all_tiles],
                     dtype=np.int32) if n else np.zeros((0,), np.int32)
    weights = np.array([t.macs for t in all_tiles], dtype=np.float32) \
        if n else np.zeros((0,), np.float32)
    g = graphs.Graph.build(adj, types=types, weights=weights)
    assert g.is_dag()
    return PreemptibleDAG(graph=g, tiles=all_tiles, task_tiles=task_tiles)


def _cap_degrees(adj: np.ndarray, cap: int = 3) -> np.ndarray:
    """Reroute excess fan-in/fan-out through NoC multicast/reduction chains.

    Engine meshes have degree ≤ 4, so a tile with 5+ producers (NASNet-style
    concat) or consumers (cell fan-out) can never embed directly. Real TSS
    hardware forwards such traffic hop-by-hop; we model it by rewriting

        fan-out u → {s₁..s_k}:  excess (u → s_j) becomes (s_{j-1} → s_j)
        fan-in  {p₁..p_k} → v:  excess (p_i → v) becomes (p_i → p_{i+1})

    with neighbours ordered topologically (earlier → later ⇒ stays a DAG)
    so precedence is preserved and the forwarding vertex already carries
    the payload.
    """
    adj = adj.copy()
    n = adj.shape[0]
    order = graphs._topo_order(adj)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    for _ in range(4):               # few passes reach a fixpoint
        changed = False
        for u in range(n):
            succs = sorted(np.where(adj[u])[0], key=lambda v: rank[v])
            while len(succs) > cap:
                v = succs.pop()      # latest consumer forwards from prior
                adj[u, v] = 0
                adj[succs[-1], v] = 1
                changed = True
        for v in range(n):
            preds = sorted(np.where(adj[:, v])[0], key=lambda u: rank[u])
            while len(preds) > cap:
                p = preds.pop(0)     # earliest producer chains forward
                adj[p, v] = 0
                adj[p, preds[0]] = 1
                changed = True
        if not changed:
            break
    return adj


def pad_problem(Q: np.ndarray, G: np.ndarray, mask: np.ndarray,
                n_bucket: int, m_bucket: int):
    """Bucket (Q, G, mask) to fixed sizes without changing semantics.

    Dummy query tiles are isolated and may only map to dedicated dummy PEs
    (one per dummy tile, also isolated), so every real matching extends to a
    padded matching and vice versa. Extra target slots beyond that are
    unreachable (all-zero mask columns).
    """
    n, m = mask.shape
    nd = n_bucket - n                     # dummy tiles
    assert nd >= 0
    m_needed = m + nd
    assert m_bucket >= m_needed, (m_bucket, m_needed)
    Qp = np.zeros((n_bucket, n_bucket), dtype=Q.dtype)
    Qp[:n, :n] = Q
    Gp = np.zeros((m_bucket, m_bucket), dtype=G.dtype)
    Gp[:m, :m] = G
    maskp = np.zeros((n_bucket, m_bucket), dtype=mask.dtype)
    maskp[:n, :m] = mask
    for d in range(nd):
        maskp[n + d, m + d] = 1           # dummy tile d ↔ dummy PE d only
    return Qp, Gp, maskp


def unpad_mapping(M: np.ndarray, n: int, m: int) -> np.ndarray:
    return M[:n, :m]


def _round_up(v: int, mult: int) -> int:
    mult = max(mult, 1)
    return ((v + mult - 1) // mult) * mult


def shape_bucket(n: int, m: int, n_multiple: int = 8,
                 m_multiple: int = 16) -> Tuple[int, int]:
    """Stable padded shape class for an (n, m) matching problem.

    Copy of the JAX service's ``shape_bucket``. The target bucket must
    leave room for the ``n_pad - n`` dummy PEs that ``pad_problem`` pins
    the dummy query tiles to.
    """
    n_pad = _round_up(max(n, 1), n_multiple)
    m_pad = _round_up(max(m, 1) + (n_pad - n), m_multiple)
    return n_pad, m_pad
