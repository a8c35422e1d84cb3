"""Graph abstractions for IMMSched subgraph-isomorphism scheduling.

The multi-DNN scheduling problem is abstracted (following IsoSched) as
matching a *query* DAG Q — tiles of the DNN workload(s) after
DAG-to-Pipeline + Layer Concatenate-and-Split — onto a *target* DAG G —
the preemptible PE/engine array of the accelerator.

Everything here is dense adjacency-matrix based: the matrices are what the
paper maps onto the accelerator's int8 MAC datapath, so dense uint8 is the
native representation, not an implementation shortcut.

Port of the JAX package's ``core/graphs.py``: the dense graph model is
numpy as before, the random constructors draw from a numpy ``Generator``
and ``as_device_graphs`` hands out torch tensors.

Vertex "compute types" model the paper's compatibility notion (e.g.
convolution tiles must land on MAC-capable PEs, max-pool tiles on
comparison-capable PEs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# Compute-type vocabulary shared by workloads and PEs. A PE with type t can
# execute a tile of type u iff COMPAT_TABLE[u, t] == 1.
TYPE_MAC = 0        # conv / matmul / attention tiles   -> MAC-array engines
TYPE_VECTOR = 1     # elementwise / norm / softmax      -> vector-capable PEs
TYPE_REDUCE = 2     # pooling / argmax / reductions     -> comparator-tree PEs
TYPE_ANY = 3        # control-ish tiles: run anywhere
NUM_TYPES = 4

# compat[tile_type, pe_type] — PEs are built as supersets: a MAC engine in a
# modern NPU also has the vector path, per the paper's "arbiters and
# selectors were added to the existing PEs".
_COMPAT = np.zeros((NUM_TYPES, NUM_TYPES), dtype=np.uint8)
_COMPAT[TYPE_MAC, TYPE_MAC] = 1
_COMPAT[TYPE_VECTOR, TYPE_MAC] = 1
_COMPAT[TYPE_VECTOR, TYPE_VECTOR] = 1
_COMPAT[TYPE_REDUCE, TYPE_REDUCE] = 1
_COMPAT[TYPE_REDUCE, TYPE_MAC] = 1
_COMPAT[TYPE_ANY, :] = 1


@dataclasses.dataclass(frozen=True)
class Graph:
    """A labelled DAG stored densely.

    adj[i, j] == 1  means a directed edge i -> j.
    types[i]        is the compute type of vertex i.
    weights[i]      optional per-vertex work estimate (MACs for tiles,
                    throughput for PEs); used by cost models, not matching.
    """

    adj: np.ndarray            # (n, n) uint8
    types: np.ndarray          # (n,)  int32
    weights: np.ndarray        # (n,)  float32

    def __post_init__(self):
        n = self.adj.shape[0]
        assert self.adj.shape == (n, n)
        assert self.types.shape == (n,)
        assert self.weights.shape == (n,)

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    @property
    def out_degree(self) -> np.ndarray:
        return self.adj.sum(axis=1).astype(np.int32)

    @property
    def in_degree(self) -> np.ndarray:
        return self.adj.sum(axis=0).astype(np.int32)

    def is_dag(self) -> bool:
        """Cheap acyclicity check via boolean matrix powers."""
        n = self.n
        reach = self.adj.astype(bool)
        power = reach.copy()
        for _ in range(max(n.bit_length(), 1)):
            power = power @ power
            reach = reach | power
        return not bool(np.any(np.diag(reach)))

    @staticmethod
    def build(adj, types=None, weights=None) -> "Graph":
        adj = np.asarray(adj, dtype=np.uint8)
        n = adj.shape[0]
        if types is None:
            types = np.full((n,), TYPE_ANY, dtype=np.int32)
        if weights is None:
            weights = np.ones((n,), dtype=np.float32)
        return Graph(adj=adj,
                     types=np.asarray(types, dtype=np.int32),
                     weights=np.asarray(weights, dtype=np.float32))


def type_compatibility(query_types: np.ndarray,
                       target_types: np.ndarray) -> np.ndarray:
    """(n, m) uint8: can tile-type i run on pe-type j."""
    return _COMPAT[np.asarray(query_types)[:, None],
                   np.asarray(target_types)[None, :]]


def compatibility_mask(query: Graph, target: Graph) -> np.ndarray:
    """Global compatibility mask Mask ∈ {0,1}^{n×m} (paper §3.2).

    mask[i, j] = 1 iff
      * target vertex j's in/out degree covers query vertex i's
        (a monomorphism needs every query edge present among the images), and
      * the compute types are compatible.
    """
    q_out = query.out_degree[:, None]
    q_in = query.in_degree[:, None]
    g_out = target.out_degree[None, :]
    g_in = target.in_degree[None, :]
    degree_ok = (q_out <= g_out) & (q_in <= g_in)
    types_ok = type_compatibility(query.types, target.types).astype(bool)
    return (degree_ok & types_ok).astype(np.uint8)


# ---------------------------------------------------------------------------
# Synthetic graph constructors (tests + benchmarks).
# ---------------------------------------------------------------------------

def line_graph(n: int, type_id: int = TYPE_ANY) -> Graph:
    adj = np.zeros((n, n), dtype=np.uint8)
    for i in range(n - 1):
        adj[i, i + 1] = 1
    return Graph.build(adj, types=np.full((n,), type_id, dtype=np.int32))


def grid_graph(rows: int, cols: int, type_id: int = TYPE_MAC,
               bidirectional: bool = False) -> Graph:
    """2-D mesh as used for the accelerator's NoC-connected engine array.

    Directed east/south edges by default (matches a systolic-forwarding
    dataflow); ``bidirectional=True`` adds the reverse links.
    """
    n = rows * cols
    adj = np.zeros((n, n), dtype=np.uint8)

    def idx(r, c):
        return r * cols + c

    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                adj[idx(r, c), idx(r, c + 1)] = 1
            if r + 1 < rows:
                adj[idx(r, c), idx(r + 1, c)] = 1
    if bidirectional:
        adj = np.maximum(adj, adj.T)
    return Graph.build(adj, types=np.full((n,), type_id, dtype=np.int32))


def random_dag(rng: np.random.Generator, n: int, edge_prob: float = 0.3,
               num_types: int = 1) -> Graph:
    """Random DAG via upper-triangular thinning (always acyclic)."""
    upper = np.triu((rng.random((n, n)) < edge_prob).astype(np.uint8), k=1)
    types = rng.integers(0, num_types, size=(n,)).astype(np.int32)
    return Graph.build(upper, types=types)


def embed_query_in_target(rng: np.random.Generator, query: Graph, m: int,
                          extra_edge_prob: float = 0.15) -> Graph:
    """Build a target graph of size m that provably contains ``query``.

    Used by tests/benchmarks so the matcher always has at least one feasible
    mapping to find. The query vertices are planted at a random injective
    position set; extra vertices/edges are noise (only edges consistent with
    a DAG ordering are added).
    """
    n = query.n
    assert m >= n
    perm = rng.permutation(m)[:n]
    types = np.full((m,), TYPE_ANY, dtype=np.int32)
    order = rng.permutation(m)                       # topological order
    rank = np.empty(m, dtype=np.int64)
    rank[order] = np.arange(m)
    # noise edges along the random topological order
    noise = (rng.random((m, m)) < extra_edge_prob).astype(np.uint8)
    fwd = (rank[:, None] < rank[None, :]).astype(np.uint8)
    adj = noise * fwd
    # plant the query: place its vertices, sorted topologically, in
    # increasing rank order so every query edge points forward
    q_order = _topo_order(query.adj)
    target_slots = perm[np.argsort(rank[perm])]
    pos = np.empty(n, dtype=np.int64)
    pos[q_order] = target_slots
    src, dst = np.nonzero(query.adj)
    adj[pos[src], pos[dst]] = 1
    types[pos] = query.types
    g = Graph.build(adj, types=types)
    assert g.is_dag(), "embedding must stay acyclic"
    return g


def _topo_order(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    indeg = adj.sum(axis=0).astype(np.int64)
    order, stack = [], [i for i in range(n) if indeg[i] == 0]
    while stack:
        v = stack.pop()
        order.append(v)
        for w in range(n):
            if adj[v, w]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
    assert len(order) == n, "graph has a cycle"
    return np.asarray(order, dtype=np.int64)


def topological_relabel(g: Graph):
    """Relabel vertices in topological order; returns (graph, order).

    The constructive (adjacency-guided) projection places vertices in
    index order and requires predecessors placed first — both the direct
    matcher and the online service relabel queries through here so their
    orders (and the service's content-digest warm keys) stay identical.
    """
    order = _topo_order(g.adj)
    return Graph(adj=g.adj[np.ix_(order, order)], types=g.types[order],
                 weights=g.weights[order]), order


def as_device_graphs(query: Graph, target: Graph, device="cuda"):
    """uint8 tensors (Q, G, Mask) on ``device``, ready for the matcher.
    Raises unless both adjacencies are 0/1: the kernels read Q and G as
    bits."""
    for name, g in (("query", query), ("target", target)):
        if not ((g.adj == 0) | (g.adj == 1)).all():
            raise ValueError(f"{name} adjacency must be 0/1")
    mask = compatibility_mask(query, target)
    return tuple(torch.as_tensor(np.ascontiguousarray(a, dtype=np.uint8),
                                 device=device)
                 for a in (query.adj, target.adj, mask))
