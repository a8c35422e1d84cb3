"""High-level matcher API, single device.

Port of the single-device part of the JAX package's ``core/matcher.py``:
``MatchResult``, the host-side result collection and ``IMMSchedMatcher``
without a mesh (the distributed builders are a later slice). Results
report ``host_syncs``, the bool fetches the early exit made.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import pso
from repro_torch.core.graphs import (Graph, as_device_graphs,
                                     topological_relabel)


@dataclasses.dataclass
class MatchResult:
    """One problem's decision, on the host: the best feasible mapping
    (in the caller's tile order) and the run's trace."""
    mapping: Optional[np.ndarray]        # best feasible (n, m) or None
    feasible_count: int
    f_star: float
    f_star_trace: np.ndarray             # (T, K) global-best trajectory
    all_mappings: np.ndarray             # (T*N, n, m) projected mappings
    all_feasible: np.ndarray             # (T*N,)
    all_fitness: np.ndarray              # (T*N,)
    carry: Optional[tuple] = None        # (S_star, f_star, S_bar) warm-start
    epochs_run: int = 0                  # epochs executed (< T on early exit)
    carry_verified: bool = False         # warm carry re-validated by one
                                         # projection (0-epoch fast path)
    prune_sweeps: int = 0                # fused pre-prune iterations run
    host_syncs: int = 0                  # early-exit bool fetches

    @property
    def found(self) -> bool:
        return self.mapping is not None


def _to_host(outs):
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in outs.items()}


def _unrelabel(M, order):
    if order is None:
        return M
    unperm = np.empty_like(M)
    unperm[..., order, :] = M
    return unperm


def collect_result(outs, order=None, crop=None) -> MatchResult:
    """Host-side gather of one problem's ``match`` output into a
    ``MatchResult``. ``order``: topological relabelling to undo;
    ``crop``: logical (n, m) to strip bucket padding to first. Device
    outputs are copied to the host once, up front."""
    outs = _to_host(outs)
    feas = np.asarray(outs["feasible"]).reshape(-1)
    fit = np.asarray(outs["fitness"]).reshape(-1)
    maps = np.asarray(outs["mappings"])
    maps = maps.reshape(-1, maps.shape[-2], maps.shape[-1])
    if crop is not None:
        maps = maps[:, :crop[0], :crop[1]]
    maps = _unrelabel(maps, order)
    best = None
    if feas.any():
        idx = np.where(feas)[0]
        best = maps[idx[np.argmax(fit[idx])]]
    carry_ok = bool(np.asarray(outs.get("carry_feasible", False)
                               ).reshape(-1)[-1])
    if best is None and carry_ok:
        # warm-carry fast path: every epoch was skipped, the re-validated
        # projection of the carried S* IS the mapping
        M_c = np.asarray(outs["carry_mapping"])
        M_c = M_c.reshape(-1, M_c.shape[-2], M_c.shape[-1])[-1]
        if crop is not None:
            M_c = M_c[:crop[0], :crop[1]]
        best = _unrelabel(M_c, order)
    return MatchResult(
        mapping=best,
        feasible_count=int(feas.sum()),
        f_star=float(np.asarray(outs["f_star"]).reshape(-1)[-1]),
        f_star_trace=np.asarray(outs["f_star_trace"]),
        all_mappings=maps, all_feasible=feas, all_fitness=fit,
        carry=(outs["S_star"], outs["f_star"], outs["S_bar"]),
        epochs_run=int(np.asarray(outs["epochs_run"]).reshape(-1)[-1]),
        carry_verified=carry_ok,
        prune_sweeps=int(np.asarray(outs.get("prune_sweeps", 0)
                                    ).reshape(-1)[-1]),
        host_syncs=int(outs.get("host_syncs", 0)))


def split_batch_outs(outs, batch: int):
    """Split a ``match_batch`` output into per-problem outputs (the
    problem axis follows the epoch axis on per-epoch leaves and leads on
    the others), each what a single ``match`` returns."""
    host = _to_host(outs)
    return [{k: (v if k == "host_syncs" else
                 v[:, b] if k in pso.PER_EPOCH else v[b])
             for k, v in host.items()}
            for b in range(batch)]


def collect_batch_results(outs, batch: int, orders=None, crops=None):
    """Per-problem ``MatchResult``s of a ``match_batch`` output."""
    return [collect_result(s, order=None if orders is None else orders[b],
                           crop=None if crops is None else crops[b])
            for b, s in enumerate(split_batch_outs(outs, batch))]


class IMMSchedMatcher:
    """High-level single-device matcher. Runs on ``device`` ("cuda"
    unless the caller asks for "cpu"); a missing card raises."""

    def __init__(self, cfg: Optional[pso.PSOConfig] = None,
                 device="cuda"):
        self.cfg = cfg or pso.PSOConfig()
        self.device = torch.device(device)

    def match(self, query: Graph, target: Graph,
              stream: Optional[pso.Stream] = None, carry0=None,
              draws=None) -> MatchResult:
        """Relabel ``query`` topologically, run ``pso.match`` on this
        matcher's device with draw ``stream`` (seed 0 if None) and
        collect the result in the caller's order."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("IMMSchedMatcher: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        query, order = topological_relabel(query)
        Q, G, mask = as_device_graphs(query, target, device=self.device)
        outs = pso.match(Q, G, mask, self.cfg, carry0, stream=stream,
                         draws=draws)
        return collect_result(outs, order=order)
