"""Target graph G: the accelerator's preemptible engine array as a DAG.

Engines are vertices; NoC mesh links (east/south forwarding, matching the
tile-cascaded TSS dataflow) are edges. A boolean ``free`` mask restricts G
to preemptible/idle engines — this is also the fault-tolerance hook: drop
failed engines from the mask and re-match (see DESIGN.md §8).

Numpy copy of the JAX package's ``accel/target_graph.py``; the port keeps its own
copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.accel.platform import Platform
from repro_torch.core import graphs


def target_graph(platform: Platform,
                 bidirectional: bool = True) -> graphs.Graph:
    g = graphs.grid_graph(platform.noc_rows, platform.noc_cols,
                          type_id=graphs.TYPE_MAC,
                          bidirectional=bidirectional)
    # engines are general-purpose after the paper's PE modifications:
    # MAC + elementwise + comparator-tree → TYPE_ANY compatibility target.
    types = np.full((g.n,), graphs.TYPE_MAC, dtype=np.int32)
    weights = np.full((g.n,), platform.macs_per_engine, dtype=np.float32)
    return graphs.Graph(adj=g.adj, types=types, weights=weights)


def free_engine_graph(platform: Platform, free: Sequence[bool],
                      bidirectional: bool = True) -> graphs.Graph:
    """Subgraph of the engine array restricted to free engines, preserving
    original engine indices via ``weights`` (weights[i] = engine id).

    Vertices keep ascending engine-id order, so two calls with the same
    free set produce byte-identical graphs — the stability the online
    matcher service's shape-bucketed compile cache and content-hashed
    warm-start keys rely on.
    """
    full = target_graph(platform, bidirectional)
    free = np.asarray(free, dtype=bool)
    assert free.shape == (full.n,)
    idx = np.where(free)[0]
    adj = full.adj[np.ix_(idx, idx)]
    types = full.types[idx]
    return graphs.Graph(adj=adj, types=types,
                        weights=idx.astype(np.float32))


def free_engine_signature(free: Sequence[bool]) -> bytes:
    """Compact, stable platform-state key: the free-engine bitmask.

    Used (together with the workload name) to scope the matcher service's
    warm-start entries to a (workload, platform-state) class.
    """
    return np.packbits(np.asarray(free, dtype=bool)).tobytes()


def signature_bits(sig: bytes) -> np.ndarray:
    """Unpacked bit vector of a ``free_engine_signature``.

    The single decode point for every consumer that compares platform
    states by engine-set overlap (the service's similarity-keyed carry
    store and the scheduler's analytic tier predictor must agree on the
    packing), so a change to the signature encoding lands in one place.
    """
    return np.unpackbits(np.frombuffer(sig, dtype=np.uint8))
