"""Layer-level workload descriptors: the DNN-side input to the scheduler.

A workload is a DAG of ``LayerSpec``s with MAC counts and activation byte
counts — enough for (a) tile-DAG lowering (core.preemptible_dag), (b) the
latency/energy cost model (accel.energy), and (c) the LTS-vs-TSS DRAM
traffic accounting that drives the paper's energy comparison.

Numpy copy of the JAX package's ``workloads/layers.py``; the port keeps its own
copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class LayerKind(enum.Enum):
    CONV = "conv"
    MATMUL = "matmul"
    ATTN = "attn"
    MOE = "moe"
    POOL = "pool"
    REDUCE = "reduce"
    NORM = "norm"
    ACT = "act"
    ELEMENTWISE = "elementwise"
    EMBED = "embed"
    SSM = "ssm"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    kind: LayerKind
    macs: float                 # multiply-accumulates for the whole layer
    bytes_moved: float          # output activation bytes (traffic unit)
    preds: Tuple[int, ...] = ()  # indices of producer layers


@dataclasses.dataclass
class WorkloadGraph:
    name: str
    layers: List[LayerSpec]

    def adjacency(self) -> np.ndarray:
        n = len(self.layers)
        adj = np.zeros((n, n), dtype=np.uint8)
        for v, spec in enumerate(self.layers):
            for u in spec.preds:
                adj[u, v] = 1
        return adj

    @property
    def total_macs(self) -> float:
        return float(sum(l.macs for l in self.layers))

    @property
    def total_bytes(self) -> float:
        return float(sum(l.bytes_moved for l in self.layers))

    def validate(self) -> None:
        adj = self.adjacency()
        n = len(self.layers)
        # acyclic: preds must come earlier (builders emit topo order)
        for v, spec in enumerate(self.layers):
            assert all(u < v for u in spec.preds), (self.name, v)
        assert adj.shape == (n, n)


class Builder:
    """Tiny sequential-with-branches builder used by the zoo."""

    def __init__(self, name: str):
        self.name = name
        self.layers: List[LayerSpec] = []

    def add(self, name: str, kind: LayerKind, macs: float, out_bytes: float,
            preds: Optional[Sequence[int]] = None) -> int:
        if preds is None:
            preds = [len(self.layers) - 1] if self.layers else []
        preds = tuple(p for p in preds if p >= 0)
        self.layers.append(LayerSpec(name=name, kind=kind, macs=macs,
                                     bytes_moved=out_bytes, preds=preds))
        return len(self.layers) - 1

    def build(self) -> WorkloadGraph:
        wg = WorkloadGraph(name=self.name, layers=self.layers)
        wg.validate()
        return wg


def conv_macs(cin: int, cout: int, k: int, oh: int, ow: int) -> float:
    return float(cin) * cout * k * k * oh * ow


def conv_out_bytes(cout: int, oh: int, ow: int, dtype_bytes: int = 1) -> float:
    return float(cout) * oh * ow * dtype_bytes
