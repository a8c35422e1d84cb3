"""High-level matcher API, on one device or sharded over a mesh.

Port of the JAX package's ``core/matcher.py``: ``MatchResult``, the
host-side result collection, the ``build_distributed_*`` functions and
``IMMSchedMatcher``. Results report ``host_syncs``, the bool fetches the
early exit made (on this rank).

The distributed paths are the paper's "particles → engines" mapping
lifted to a mesh. Every rank of the mesh calls the function a
``build_distributed_*`` returns as one SPMD program, with the same
inputs, in the same order, as ``shard_map`` runs the reference's body on
every device. Each rank runs its own local swarm through the
single-device path (the same kernels), and the paper's *global
controller* is one collective schedule an epoch (``launch/mesh.py``,
over the group of ``axis_names``):

  * global best S*, f* — ``all_reduce(MAX)`` of f*, then a masked
    ``all_reduce(SUM)`` of S* and of the count (ties averaged);
  * consensus S̄ — a global softmax over the union of the local elites,
    with a MAX-stabilised exponent: two sums, reduced in one
    ``all_reduce(SUM)``;
  * the epoch's f* trace — ``all_reduce(MAX)``;
  * the early exit — the found-predicate ``all_reduce(MAX)``'d before
    its one bool fetch, so every rank takes the same branch.

Outputs follow the reference's ``out_specs``: per-particle leaves are
gathered on the particle axis in shard order (data-major), per-problem
leaves of the problem-sharded regime on the problem axis, and the
controller state is replicated. Sums across ranks are not bit-stable
across backends or shard counts; S* is exact whenever one shard holds
the best (the others add zeros).

Draws per shard. The reference gives shard d ``split(key, D)[d]``. Here
a problem's stream becomes D shard streams by ``shard_streams``: a seed
s gives shard d the seed ``s·D + d`` (s itself when D = 1), so no two
shards of one mesh share a stream and a world of one draws what the
single-device path draws; a sequence of D streams (how tests hand in
the reference's per-shard draws) is taken as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import pso
from repro_torch.core.graphs import (Graph, as_device_graphs,
                                     topological_relabel)
from repro_torch.kernels import backend as kernel_backend
from repro_torch.kernels import ref
from repro_torch.kernels.finish_fused import elite_top_k
from repro_torch.launch import mesh as mesh_lib

MAX, SUM = dist.ReduceOp.MAX, dist.ReduceOp.SUM


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


def shard_streams(stream, num_shards: int) -> list:
    """The ``num_shards`` draw streams of one problem on a mesh: an int
    seed s gives shard d the seed ``s·D + d`` (s itself at D = 1); a
    sequence of D streams passes through; any other stream (a generator
    or a callable) serves a single shard only."""
    if isinstance(stream, (list, tuple)):
        if len(stream) != num_shards:
            raise ValueError(f"{len(stream)} shard streams for "
                             f"{num_shards} shards")
        return list(stream)
    if num_shards == 1:
        return [stream]
    if isinstance(stream, (int, np.integer)):
        return [int(stream) * num_shards + d for d in range(num_shards)]
    raise ValueError("a stream that is not a seed serves one shard: pass "
                     "one stream per shard")


def _fuse_global_best(S_star, f_star, ax):
    """The global-best particle without gathering every shard's S*: MAX
    of the scalar f*, then a masked SUM of S* and of the winners' count
    (ties, of equal fitness, averaged)."""
    f_gmax = mesh_lib.all_reduce(f_star, MAX, ax)
    is_best = (f_star >= f_gmax).to(S_star.dtype)
    packed = mesh_lib.all_reduce(
        torch.cat([(S_star * is_best).reshape(-1), is_best.reshape(1)]),
        SUM, ax)
    return (packed[:-1].reshape(S_star.shape)
            / packed[-1].clamp(min=1.0)), f_gmax


def _fuse_consensus(S, f, cfg: pso.PSOConfig, ax):
    """Global elite consensus across shards (the paper's global
    controller): each shard's lower-index-first top-k, weighted by
    exp((f − global max) / temp), summed with its weight total across
    the shards; S̄ is their quotient."""
    f = f.float()
    f_gmax = mesh_lib.all_reduce(f.max(), MAX, ax)
    k = max(1, int(round(cfg.elite_frac * S.shape[0])))
    idx, f_top = elite_top_k(f, k)
    w = torch.exp(ref.fdiv(f_top - f_gmax, cfg.consensus_temp))
    weighted = (w[:, None, None] * S.float()[idx]).sum(0)
    packed = mesh_lib.all_reduce(
        torch.cat([weighted.reshape(-1), w.sum().reshape(1)]), SUM, ax)
    return (packed[:-1].reshape(weighted.shape)
            / packed[-1].clamp(min=1e-20))


def build_distributed_match(Q_shape: Tuple[int, int], mesh,
                            cfg: pso.PSOConfig,
                            axis_names: Sequence[str] = ("data",)):
    """``match(streams, Q, G, mask, carry0=None)``: Algorithm 1 for one
    problem with the swarm sharded over ``axis_names`` of ``mesh``, each
    shard running ``cfg.num_particles`` particles.

    ``streams`` holds one draw stream per shard (``shard_streams``);
    ``Q``/``G``/``mask``/``carry0`` are the same on every rank (a cold
    start when ``carry0`` is None). Returns the ``pso.match`` dict with
    the per-particle leaves gathered: mappings (T, D·N, n, m),
    feasible / fitness (T, D·N); the rest replicated."""
    ax = mesh_lib.mesh_axes(mesh, axis_names)
    bk = kernel_backend.for_config(cfg)

    def all_found(found):
        return mesh_lib.all_reduce(found, MAX, ax)

    def match(streams, Q, G, mask, carry0=None):
        if len(streams) != ax.size:
            raise ValueError(f"{len(streams)} streams for {ax.size} shards")
        n, m = mask.shape
        dev = mask.device
        if carry0 is None:
            carry0 = pso.default_carry(mask)
        if cfg.prune_mask:
            mask, prune_sweeps = bk.prune_fixpoint(mask, Q, G,
                                                   cfg.prune_iters)
        else:
            prune_sweeps = torch.zeros((), dtype=torch.int32, device=dev)
        draw = pso._draw_fns([streams[ax.index]], 1, cfg.num_particles, n,
                             m, cfg, dev)
        fast = cfg.early_exit and cfg.carry_fastpath
        if fast:
            # carry0/Q/G/mask are the same on every rank, so is the verdict
            M_c, carry_ok = pso.carry_fast_path(carry0, Q, G, mask, cfg)
        else:
            M_c = torch.zeros(n, m, dtype=torch.uint8, device=dev)
            carry_ok = torch.zeros((), dtype=torch.bool, device=dev)

        def run_one(carry, t):
            d = {k: (None if v is None else v[0]) for k, v in
                 pso._epoch_draws(None, draw, t, cfg, dev).items()}
            carry, outs = pso.run_epoch(carry, d, Q, G, mask, cfg)
            S_star, f_star, _ = carry
            # ---- global controller: fuse across the mesh ----
            S_star, f_star = _fuse_global_best(S_star, f_star, ax)
            S_bar = _fuse_consensus(outs.pop("S_final"), outs["fitness"],
                                    cfg, ax)
            outs["f_star_trace"] = mesh_lib.all_reduce(
                outs["f_star_trace"], MAX, ax)
            return (S_star, f_star, S_bar), outs

        (S_star, f_star, S_bar), outs, epochs_run, syncs = pso.scan_epochs(
            run_one, carry0, n, m, cfg, done0=carry_ok if fast else None,
            all_found=all_found)
        for k in ("mappings", "feasible", "fitness"):
            outs[k] = mesh_lib.all_gather(outs[k], 1, ax)
        outs.update(S_star=S_star, f_star=f_star, S_bar=S_bar,
                    epochs_run=epochs_run, carry_mapping=M_c,
                    carry_feasible=carry_ok, prune_sweeps=prune_sweeps,
                    host_syncs=syncs)
        return outs

    return match


def _problem_axis(batch: int, ax) -> bool:
    """The problem-sharded regime: B whole problems split evenly."""
    return batch >= ax.size and batch % ax.size == 0


def _gather_problems(outs, ax, per_epoch=pso.PER_EPOCH):
    """Per-problem leaves of a rank's slice gathered on the problem axis
    (after the epoch axis on the ``per_epoch`` leaves)."""
    return {k: (v if k == "host_syncs" else mesh_lib.all_gather(
        v, 1 if k in per_epoch else 0, ax)) for k, v in outs.items()}


def build_distributed_match_batch(Q_shape: Tuple[int, int], mesh,
                                  cfg: pso.PSOConfig,
                                  axis_names: Sequence[str] = ("data",),
                                  batch: int = 1):
    """``match(streams, Qb, Gb, maskb, carry0=None)`` for a stacked batch
    of B problems on the mesh, one stream per problem. Two regimes:

      * **problem-axis sharding** (B ≥ shards and divisible): each shard
        solves its B/D whole problems with ``pso.match_batch`` — no
        collective until the outputs are gathered, and each problem's
        result is bit for bit the single-device one (same stream);
      * **per-problem particle sharding** (small B):
        ``build_distributed_match`` per problem, each problem's stream
        split by ``shard_streams``, stacked on the problem axis.

    Output layout is ``pso.match_batch``'s; ``host_syncs`` counts this
    rank's fetches."""
    ax = mesh_lib.mesh_axes(mesh, axis_names)
    if _problem_axis(batch, ax):
        per = batch // ax.size

        def match(streams, Qb, Gb, maskb, carry0=None):
            sl = slice(ax.index * per, (ax.index + 1) * per)
            if carry0 is None:
                carry0 = pso.default_carry_batch(maskb)
            outs = pso.match_batch(Qb[sl], Gb[sl], maskb[sl], cfg,
                                   tuple(c[sl] for c in carry0),
                                   streams=list(streams)[sl])
            return _gather_problems(outs, ax)

        return match

    per_problem = build_distributed_match(Q_shape, mesh, cfg, axis_names)

    def match(streams, Qb, Gb, maskb, carry0=None):
        outs = [per_problem(shard_streams(streams[b], ax.size), Qb[b],
                            Gb[b], maskb[b],
                            None if carry0 is None else
                            tuple(c[b] for c in carry0))
                for b in range(batch)]
        stacked = {k: torch.stack([o[k] for o in outs],
                                  1 if k in pso.PER_EPOCH else 0)
                   for k in outs[0] if k != "host_syncs"}
        stacked["host_syncs"] = sum(o["host_syncs"] for o in outs)
        return stacked

    return match


def build_distributed_revalidate_batch(Q_shape: Tuple[int, int], mesh,
                                       cfg: pso.PSOConfig,
                                       axis_names: Sequence[str] =
                                       ("data",),
                                       batch: int = 1,
                                       donate: bool = False):
    """``revalidate(Qb, Gb, maskb, carry0)``: the tiered pipeline's
    cheap stage (``pso.revalidate_batch``, ``donate`` as there) on the
    mesh. It has no swarm and no collective of its own, so both regimes
    are embarrassingly parallel and bit for bit the single-device call:

      * **problem-axis sharding** (B ≥ shards and divisible): each shard
        revalidates its B/D carries, outputs gathered on the problem axis;
      * **replicated** (small B): every rank computes the whole batch."""
    ax = mesh_lib.mesh_axes(mesh, axis_names)
    if not _problem_axis(batch, ax):
        def revalidate(Qb, Gb, maskb, carry0):
            return pso.revalidate_batch(Qb, Gb, maskb, cfg, carry0,
                                        donate=donate)
        return revalidate
    per = batch // ax.size

    def revalidate(Qb, Gb, maskb, carry0):
        sl = slice(ax.index * per, (ax.index + 1) * per)
        outs = pso.revalidate_batch(Qb[sl], Gb[sl], maskb[sl], cfg,
                                    tuple(c[sl] for c in carry0),
                                    donate=donate)
        return _gather_problems(outs, ax, per_epoch=())

    return revalidate


class IMMSchedMatcher:
    """High-level matcher on ``device`` ("cuda" unless the caller asks
    for "cpu"; a missing card raises). Single-device by default; with a
    ``mesh`` (``launch.mesh.make_host_mesh``) the swarm is sharded over
    ``axis_names``, each shard running ``cfg.num_particles`` particles,
    and every rank of the mesh must call ``match`` alike."""

    def __init__(self, cfg: Optional[pso.PSOConfig] = None, mesh=None,
                 axis_names: Sequence[str] = ("data",), device="cuda"):
        self.cfg = cfg or pso.PSOConfig()
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)

    def match(self, query: Graph, target: Graph,
              stream: Optional[pso.Stream] = None, carry0=None,
              draws=None) -> MatchResult:
        """Relabel ``query`` topologically, run Algorithm 1 on this
        matcher's device with draw ``stream`` (seed 0 if None; on a mesh
        a seed or one stream per shard, see ``shard_streams``) and
        collect the result in the caller's order. ``draws`` (single
        device only) replaces the stream."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("IMMSchedMatcher: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        query, order = topological_relabel(query)
        Q, G, mask = as_device_graphs(query, target, device=self.device)
        if self.mesh is None:
            outs = pso.match(Q, G, mask, self.cfg, carry0, stream=stream,
                             draws=draws)
        else:
            if draws is not None:
                raise ValueError("a mesh draws per shard: pass a stream "
                                 "per shard, not draws")
            fn = build_distributed_match(Q.shape, self.mesh, self.cfg,
                                         self.axis_names)
            D = mesh_lib.mesh_axes(self.mesh, self.axis_names).size
            outs = fn(shard_streams(0 if stream is None else stream, D),
                      Q, G, mask, carry0)
        return collect_result(outs, order=order)
