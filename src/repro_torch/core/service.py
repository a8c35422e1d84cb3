"""Online matcher service: a tiered revalidate → rebase → swarm pipeline.

Port of the JAX package's ``core/service.py`` without the reference's
executable cache (the port compiles nothing per shape; see
``core/persist.py``). ``pso.match``
alone is a batch API: every call restarts the swarm from the cold prior
and takes whatever (n, m) it is given. The ``MatcherService`` turns it
into a service:

  * **Shape classes** — query/target problems are bucketed to padded
    ``(n_pad, m_pad)`` classes via ``preemptible_dag.pad_problem`` (dummy
    tiles pinned to dummy PEs, semantics preserved), so repeat arrivals of
    any size within a bucket share one launch shape.
  * **Bounded callable LRU** — one bound launch callable per (kind,
    bucket, batch class), held in an LRU of ``cache_capacity`` entries.
    The port compiles nothing per bucket (its kernels take any shape up
    to 256), so an entry's first call stands for the reference's trace:
    ``compile_cache_hits``/``misses`` and ``jit_traces`` count as there.
  * **Warm starts** — the final global-controller state ``(S*, f*, S̄)`` of
    each call is remembered in a two-level :class:`CarryStore`: an *exact*
    content-keyed LRU plus a *similarity* index keyed by
    (query digest, bucket, free-engine signature) for platform-state
    drift. The carries themselves live in a :class:`DeviceCarryPool` on
    the service's device.
  * **Early exit** — the service enables ``cfg.early_exit`` so easy
    matches stop scanning epochs once a feasible mapping clears the
    fitness bound.

**The tiered decision pipeline.** ``drain`` flushes every same-bucket
request through three stages:

  * **Tier 0 — batched revalidation.** All requests with a stored exact
    carry are re-validated in ONE ``pso.revalidate_batch`` launch: one
    structured projection + feasibility check per problem, no epochs.
  * **Tier 1 — similarity rebase.** Tier-0 misses (and cold requests)
    whose workload matches a *similar* platform state — same query
    digest, nearest free-engine set by bitmask overlap — are re-run
    through the same revalidation with the neighbour's carry, which
    ``pso.rebase_carry`` projects onto the new compatibility mask. The
    verified mapping is feasibility-checked against the actual problem.
  * **Tier 2 — swarm.** Only the residual misses launch the batched
    swarm (``pso.match_batch``), warm-seeded with their failed exact
    carry or the rebased neighbour consensus (f* reset to -inf).

Batch launches are padded to a small set of classes (``batch_classes``);
pad slots hold a *trivial pre-finished problem* whose carry validates in
epoch 0, so padding never re-burns a real problem's epoch budget.

Random numbers. Each request carries its own draw stream (``key``: an int
seed, default 0, or a callable of the epoch, see ``pso.Stream``), the
port's form of the reference's per-request PRNG key. A pad slot draws
from the stream of the request it copies. A request's draws therefore
never depend on its batch mates, its slot or the batch class.

Host syncs. Every fetch of results goes through ``_sync_fetch``: pinned
non-blocking copies of the whole output tree and one wait. The swarm's
early exit also fetches one bool per epoch inside ``pso.match_batch``;
those blocking fetches count in ``host_syncs`` too. An all-warm drain
costs exactly one.

**Warm-restart persistence.** With ``persist_dir`` (or
``REPRO_PERSIST_DIR``), ``save_snapshot`` / ``restore_snapshot`` carry
the :class:`CarryStore` (exact and similarity carries, in LRU order) and
the prune-sweep calibration counters across a process restart through
:class:`~repro_torch.checkpoint.manager.CheckpointManager` under
``<persist_dir>/snapshots/``: one blocking transfer a save, versioned
and guarded by ``config_digest``; restored carries go back into the
device pool.

**On a mesh.** ``MatcherService(mesh=, axis_names=)`` runs each launch
as the distributed matcher (``core/matcher.py``): the swarm's
``build_distributed_match`` / ``_batch`` and the sharded revalidation.
Every rank of the mesh builds the same service and submits and drains
the same requests in the same order; every decision a drain branches on
comes from replicated outputs, so each rank takes the same path and
holds the same store. A request's seed gives each shard its own stream
(``matcher.shard_streams``). Every output of a distributed launch is a
plain tensor on this rank's device (gathered or replicated), so a mesh
service keeps its carries in its own ``DeviceCarryPool`` like a
single-device one (the reference skips its pool here only because its
outputs carry mesh shardings). One rank writes a snapshot, behind a
barrier, that every rank restores. ``host_syncs`` counts this rank's
own fetches.

Per-tier statistics (launches / problems checked / hits / wall time) are
exported via ``stats`` / ``stats_dict()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.accel.target_graph import signature_bits
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import persist, pso
from repro_torch.core.graphs import (Graph, compatibility_mask,
                                     topological_relabel)
from repro_torch.core.matcher import (MatchResult,
                                      build_distributed_match,
                                      build_distributed_match_batch,
                                      build_distributed_revalidate_batch,
                                      collect_batch_results, collect_result,
                                      shard_streams)
from repro_torch.core.preemptible_dag import pad_problem, shape_bucket
from repro_torch.kernels import backend as kernel_backend
from repro_torch.launch import mesh as mesh_lib

@dataclasses.dataclass
class TierStats:
    """Counters for one pipeline stage."""
    launches: int = 0                # launches this tier issued
    checked: int = 0                 # real problems examined
    hits: int = 0                    # requests served by this tier
    wall_s: float = 0.0              # wall time spent in this tier

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.checked, 1)


@dataclasses.dataclass
class ServiceStats:
    """Cumulative counters for one ``MatcherService`` incarnation.

    Counters cover the callable LRU, warm-start stores, per-tier pipeline
    activity, the fused pre-prune observable the scheduler calibrates
    against, the async front end, the host-sync census and the
    warm-restart persistence layer (``snapshot_*``, ``restored_*``; the
    reference's ``aot_*`` counters stay 0, since the port has no
    executable cache). Exported flat — plus derived rates — by
    ``MatcherService.stats_dict()``."""
    calls: int = 0
    compile_cache_hits: int = 0      # bucket already had a callable
    compile_cache_misses: int = 0    # new (kind, bucket, class) entry
    compile_evictions: int = 0
    warm_hits: int = 0               # exact carry found for the call
    warm_misses: int = 0
    warm_evictions: int = 0
    epochs_run: int = 0              # total epochs actually executed
    epochs_budgeted: int = 0         # cfg.epochs × calls
    epoch_fused_launches: int = 0    # swarm dispatches whose epochs ran
                                     # through the fused epoch kernel
    epoch_finish_launches: int = 0   # swarm dispatches whose epoch tail
                                     # ran through epoch_finish
    epoch_finish_problems: int = 0   # problems those epilogues covered
    found: int = 0
    batch_launches: int = 0          # swarm (Tier-2) batch executions
    coalesced_requests: int = 0      # requests served in a shared launch
    batch_problems: int = 0          # real problems through the swarm path
    batch_slots: int = 0             # padded swarm batch slots launched
    carry_fastpath_hits: int = 0     # requests served by revalidation only
                                     # (0 epochs: Tier 0, Tier 1, or the
                                     # in-launch fast path)
    pad_slots_frozen: int = 0        # pad slots pre-finished from epoch 0
    prune_problems: int = 0          # real problems that ran the pre-prune
    prune_sweeps: int = 0            # total fused prune iterations executed
    sim_lookups: int = 0             # similarity-store nearest() queries
    sim_neighbor_hits: int = 0       # queries that found a neighbour carry
    sim_evictions: int = 0
    jit_traces: int = 0              # first calls of LRU entries (the
                                     # reference's jit traces)
    # -- warm-restart persistence ----------------------------------------
    # the reference's executable-cache counters: always 0 here
    aot_cache_hits: int = 0
    aot_cache_misses: int = 0
    aot_exports: int = 0
    aot_export_failures: int = 0
    aot_call_fallbacks: int = 0
    # snapshots
    snapshot_saves: int = 0
    snapshot_restores: int = 0       # successful state restores
    snapshot_stale_skipped: int = 0  # version/digest drift → ignored
    snapshot_skipped_keys: int = 0   # entries with unencodable keys
    restored_carries: int = 0        # exact carries loaded by restore
    restored_sim_entries: int = 0    # similarity entries loaded by restore
    # -- async front end (AsyncServiceFrontEnd) ------------------------
    fe_submitted: int = 0            # requests offered to the front end
    fe_admitted: int = 0             # requests accepted into the queue
    fe_shed: int = 0                 # rejected by admission control
    fe_forced_drains: int = 0        # block-policy drains to make room
    fe_drains: int = 0               # total front-end drain rounds
    fe_drain_deadline: int = 0       # rounds fired by slack crossing
    fe_drain_batch_full: int = 0     # rounds fired by a full batch class
    fe_drain_flush: int = 0          # rounds fired by explicit flush
    fe_queue_peak: int = 0           # max observed queue depth
    fe_wait_s: float = 0.0           # total queue-wait time (admit→drain)
    # -- host-sync census -----------------------------------------------
    drains: int = 0                  # drain rounds that flushed requests
    host_syncs: int = 0              # blocking device→host fetches: one
                                     # per pipeline stage under the
                                     # pipelined drain, one per launch
                                     # under the serial arm, plus the
                                     # swarm's early-exit bool fetches
    host_bytes_transferred: int = 0  # payload bytes _sync_fetch moved
    host_sync_wall_s: float = 0.0    # wall time blocked in _sync_fetch
    donated_launches: int = 0        # revalidation launches allowed to
                                     # overwrite their gathered carries
    tier0: TierStats = dataclasses.field(default_factory=TierStats)
    tier1: TierStats = dataclasses.field(default_factory=TierStats)
    tier2: TierStats = dataclasses.field(default_factory=TierStats)

    @property
    def epochs_saved(self) -> int:
        """Budgeted minus executed epochs (early exit + fast paths)."""
        return self.epochs_budgeted - self.epochs_run

    @property
    def compile_hit_rate(self) -> float:
        """Fraction of calls served by an already-bound callable."""
        return self.compile_cache_hits / max(self.calls, 1)

    @property
    def warm_hit_rate(self) -> float:
        """Fraction of calls that found an exact stored carry."""
        return self.warm_hits / max(self.calls, 1)

    @property
    def revalidated_rate(self) -> float:
        """Fraction of calls served without any swarm epoch (all tiers)."""
        return self.carry_fastpath_hits / max(self.calls, 1)

    @property
    def avg_prune_sweeps(self) -> float:
        """Mean fused pre-prune iterations per pruned problem."""
        return self.prune_sweeps / max(self.prune_problems, 1)

    @property
    def batch_occupancy(self) -> float:
        """Real problems per launched swarm slot (1.0 = no padding waste;
        vacuously 1.0 without a swarm launch)."""
        if self.batch_slots == 0:
            return 1.0
        return self.batch_problems / self.batch_slots

    @property
    def host_syncs_per_drain(self) -> float:
        """Blocking device→host fetches per drain round — ONE for an
        all-warm pipelined drain. Counts single ``match`` calls too, so
        read it on drain-only traffic."""
        return self.host_syncs / max(self.drains, 1)


@dataclasses.dataclass
class ServiceMatchResult(MatchResult):
    bucket: Tuple[int, int] = (0, 0)
    compile_cache_hit: bool = False
    warm_hit: bool = False
    latency_s: float = 0.0           # wall time of the launches that
                                     # served this request
    batch_size: int = 1              # real problems in the serving launch
    coalesced: bool = False          # served together with other requests
    tier: int = 2                    # pipeline stage that served it:
                                     # 0 revalidate, 1 rebase, 2 swarm


@dataclasses.dataclass
class _PendingRequest:
    """A submitted problem, pre-padded to its shape bucket so ``drain``
    can group by bucket without touching the graphs again."""
    key: pso.Stream                      # the request's draw stream
    workload_key: object
    order: np.ndarray
    crop: Tuple[int, int]
    bucket: Tuple[int, int]
    Qp: np.ndarray
    Gp: np.ndarray
    maskp: np.ndarray
    engine_sig: Optional[bytes] = None   # free-engine bitmask (Tier-1 key)
    qdigest: str = ""                    # query-content digest (Tier-1 key)
    cdigest: str = ""                    # full-content digest (Tier-0 key)


@dataclasses.dataclass(eq=False)
class _PipelineItem:
    """One request flowing through the tiers of a bucket-group pipeline."""
    req: _PendingRequest
    ticket: int
    warm_key: Tuple
    carry: Optional[tuple]           # exact stored carry (Tier-0 input)
    warm_hit: bool
    seed: Optional[tuple] = None     # rebased neighbour carry (Tier-2 seed)
    t0: float = 0.0                  # pipeline intake timestamp
    latency_s: float = 0.0           # intake → end of the serving launch
    result: Optional[ServiceMatchResult] = None


@dataclasses.dataclass(eq=False)
class _LaunchRecord:
    """One dispatched-but-not-fetched launch of the drain pipeline.

    The pipelined drain splits every tier launch into a *dispatch* half
    (build inputs, enqueue the launch — CUDA returns before the device
    finishes) and an *apply* half (consume the fetched host outputs).
    Records carry everything the apply half needs, so all launches of a
    stage can dispatch back to back and resolve through ONE fetch."""
    kind: str                        # "reval" | "swarm"
    bucket: Tuple[int, int]
    items: List[_PipelineItem]
    tier: int
    B: int                           # real problems in the launch
    bclass: int                      # padded batch class dispatched
    compile_hit: bool
    outs: dict                       # device-side outputs
    carries: Optional[List] = None   # reval: per-item input carries
    padded: Optional[List] = None    # swarm: padded request list
    miss_sink: Optional[List] = None # reval: where misses are appended
    t0: float = 0.0                  # dispatch timestamp


class CarryStore:
    """Two-level warm-start store for the tiered pipeline.

    * **exact** — LRU of full content keys (workload key + shapes + a
      digest of Qp/Gp/maskp): a hit means *this exact problem* was solved
      before; its carry feeds Tier 0.
    * **similarity** — LRU keyed by ``(query digest, bucket, engine
      signature)``: entries describe *which platform state* a carry was
      produced on. ``nearest`` returns the stored carry whose free-engine
      bitmask overlaps the query's the most (ties go to the most recently
      stored), feeding Tier 1 rebases under fragmentation drift.

    ``nearest`` probes a **popcount-bucketed index**: entries of one
    (query digest, bucket) group are binned by the popcount of their
    free-engine bitmask, and bins are visited in decreasing order of the
    best overlap they could possibly hold (``min(pop, query_pop)``),
    stopping as soon as the bound cannot beat the best hit found. The
    exhaustive linear scan is kept as ``_nearest_linear``
    (``sim_index=False`` fallback, and the oracle the index is tested
    against).

    Popcounts are computed ONCE on host numpy when an entry is ingested
    (``_sim_pop``), so no store operation reduces a bit vector per stored
    entry again.

    The store is payload-agnostic (tests store plain ints), but it takes
    part in device-carry lifetime management: any stored value exposing
    ``retain``/``release`` (the service's :class:`DeviceCarryPool`
    handles) is retained on insert and released when it is overwritten or
    evicted, so slab rows are reclaimed the moment no store references
    them.
    """

    def __init__(self, capacity: int, sim_capacity: int,
                 stats: ServiceStats, sim_index: bool = True):
        self.capacity = max(int(capacity), 1)
        self.sim_capacity = max(int(sim_capacity), 1)
        self.stats = stats
        self.sim_index = bool(sim_index)
        self._exact: "OrderedDict[Tuple, tuple]" = OrderedDict()
        self._sim: "OrderedDict[Tuple, Tuple[np.ndarray, tuple]]" = \
            OrderedDict()
        # recency sequence per similarity key (== iteration order of
        # ``_sim``): the index's explicit most-recent-wins tiebreaker
        self._sim_seq: Dict[Tuple, int] = {}
        self._seq = 0
        # (qdigest, bucket, bit-length) -> {popcount: OrderedDict[sig]}
        self._sim_buckets: Dict[Tuple, Dict[int, "OrderedDict[bytes, None]"]] \
            = {}
        # per-entry popcount, computed once at ingest (host numpy)
        self._sim_pop: Dict[Tuple, int] = {}

    def __len__(self) -> int:
        return len(self._exact)

    @property
    def sim_entries(self) -> int:
        """Number of entries currently in the similarity store."""
        return len(self._sim)

    @staticmethod
    def _retain(carry) -> None:
        r = getattr(carry, "retain", None)
        if callable(r):
            r()

    @staticmethod
    def _release(carry) -> None:
        r = getattr(carry, "release", None)
        if callable(r):
            r()

    def clear(self) -> None:
        """Drop both stores and the derived popcount index/recency,
        releasing every device-pool carry they referenced."""
        for c in self._exact.values():
            self._release(c)
        for _, c in self._sim.values():
            self._release(c)
        self._exact.clear()
        self._sim.clear()
        self._sim_seq.clear()
        self._sim_buckets.clear()
        self._sim_pop.clear()

    # -- exact tier --------------------------------------------------------

    def get(self, key) -> Tuple[Optional[tuple], bool]:
        """Exact-store lookup → ``(carry, hit)``; refreshes LRU recency
        and counts ``warm_hits``/``warm_misses``."""
        if key in self._exact:
            self._exact.move_to_end(key)
            self.stats.warm_hits += 1
            return self._exact[key], True
        self.stats.warm_misses += 1
        return None, False

    def put(self, key, carry) -> None:
        """Store ``carry`` (a ``(S*, f*, S̄)`` tuple, or a device-pool
        handle of one) under the exact content key, evicting LRU entries
        beyond ``capacity``."""
        old = self._exact.get(key)
        if old is not None and old is not carry:
            self._release(old)
        if old is not carry:
            self._retain(carry)
        self._exact[key] = carry
        while len(self._exact) > self.capacity:
            _, evicted = self._exact.popitem(last=False)
            self._release(evicted)
            self.stats.warm_evictions += 1

    # -- similarity tier ---------------------------------------------------

    @staticmethod
    def _bits(sig: bytes) -> np.ndarray:
        return np.asarray(signature_bits(sig))

    def put_similar(self, qdigest: str, bucket: Tuple[int, int],
                    sig: bytes, carry) -> None:
        """Store ``carry`` under the similarity key (query digest, shape
        bucket, free-engine signature) and index it by signature
        popcount (computed once, at ingest); refreshes recency for
        most-recent-wins ``nearest`` tiebreaks."""
        key = (qdigest, bucket, sig)
        bits = self._bits(sig)
        prev = self._sim.get(key)
        fresh = prev is None
        if not fresh and prev[1] is not carry:
            self._release(prev[1])
        if fresh or prev[1] is not carry:
            self._retain(carry)
        self._sim[key] = (bits, carry)
        self._sim.move_to_end(key)
        self._seq += 1
        self._sim_seq[key] = self._seq
        if fresh:
            pc = int(bits.sum())
            self._sim_pop[key] = pc
            group = self._sim_buckets.setdefault(
                (qdigest, bucket, bits.shape[0]), {})
            group.setdefault(pc, OrderedDict())[sig] = None
        while len(self._sim) > self.sim_capacity:
            old_key, (old_bits, old_carry) = self._sim.popitem(last=False)
            self._drop_sim_key(old_key, old_bits)
            self._release(old_carry)
            self.stats.sim_evictions += 1

    def _drop_sim_key(self, key: Tuple, bits: np.ndarray) -> None:
        """Remove an evicted similarity entry from the popcount index
        (its popcount comes from the ingest-time cache)."""
        qd, bk, sig = key
        self._sim_seq.pop(key, None)
        pc = self._sim_pop.pop(key)
        gkey = (qd, bk, bits.shape[0])
        group = self._sim_buckets.get(gkey)
        if group is None:
            return
        bin_ = group.get(pc)
        if bin_ is not None:
            bin_.pop(sig, None)
            if not bin_:
                del group[pc]
        if not group:
            del self._sim_buckets[gkey]

    def nearest(self, qdigest: str, bucket: Tuple[int, int], sig: bytes,
                exclude_sig: Optional[bytes] = None
                ) -> Optional[Tuple[bytes, tuple]]:
        """Stored carry of the platform state nearest to ``sig``.

        Nearest = max popcount of the AND of the free-engine bitmasks;
        ties broken toward the smaller symmetric difference, then toward
        the most recently stored entry. Returns ``(stored_sig, carry)``
        or None when no same-workload entry overlaps at all. Served from
        the popcount-bucketed index (identical results to
        ``_nearest_linear``) unless ``sim_index`` is off.
        """
        if not self.sim_index:
            return self._nearest_linear(qdigest, bucket, sig, exclude_sig)
        bits = self._bits(sig)
        qpop = int(bits.sum())
        group = self._sim_buckets.get((qdigest, bucket, bits.shape[0]))
        if not group or qpop == 0:
            return None

        def upper_bound(pc: int) -> Tuple[int, int]:
            # best (overlap, -symdiff) any popcount-pc bitmask can score
            ov = min(pc, qpop)
            return ov, -(pc + qpop - 2 * ov)

        best = None
        best_score = (0, float("-inf"), -1)     # (overlap, -symdiff, seq)
        for pc in sorted(group, key=upper_bound, reverse=True):
            ub = upper_bound(pc)
            if ub[0] <= 0 or ub < (best_score[0], best_score[1]):
                break        # bins are bound-sorted: nothing below can win
            for s in group[pc]:
                if s == exclude_sig:
                    continue
                key = (qdigest, bucket, s)
                b, carry = self._sim[key]
                overlap = int((b & bits).sum())
                if overlap <= 0:
                    continue
                score = (overlap, -int((b ^ bits).sum()),
                         self._sim_seq[key])
                if score > best_score:
                    best_score = score
                    best = (s, carry)
        return best

    # -- state export / import ---------------------------------------------

    def export_state(self) -> Tuple[List[Tuple[Tuple, tuple]],
                                    List[Tuple[Tuple, tuple]]]:
        """Both stores as ``(exact_items, sim_items)`` key/carry lists, in
        LRU order (least recent first), so an ``import_state`` replay
        reproduces recency. Carries are returned as stored."""
        exact = [(k, c) for k, c in self._exact.items()]
        sim = [(k, c) for k, (_, c) in self._sim.items()]
        return exact, sim

    def import_state(self, exact_items, sim_items) -> Tuple[int, int]:
        """Replay exported items into this (fresh) store, oldest first,
        through the normal ``put``/``put_similar`` paths, so the popcount
        index and recency are rebuilt. Returns ``(n_exact, n_sim)``
        loaded; entries beyond the capacities age out as live puts
        would."""
        for k, c in exact_items:
            self.put(k, c)
        for (qdigest, bucket, sig), c in sim_items:
            self.put_similar(qdigest, bucket, sig, c)
        return len(exact_items), len(sim_items)

    def _nearest_linear(self, qdigest: str, bucket: Tuple[int, int],
                        sig: bytes, exclude_sig: Optional[bytes] = None
                        ) -> Optional[Tuple[bytes, tuple]]:
        """Exhaustive-scan fallback (and the index's test oracle)."""
        bits = self._bits(sig)
        best = None
        best_score = (0, float("-inf"))
        for (qd, bk, s), (b, carry) in self._sim.items():
            if qd != qdigest or bk != bucket or s == exclude_sig:
                continue
            if b.shape != bits.shape:
                continue
            overlap = int((b & bits).sum())
            if overlap <= 0:
                continue
            score = (overlap, -int((b ^ bits).sum()))
            if score >= best_score:     # >=: most recent wins ties
                best_score = score
                best = (s, carry)
        return best


def store_state_from_numpy(exact_items, sim_items, device="cuda"):
    """The store-level ``pso.carry_from_numpy``: key/carry lists whose
    carries are numpy ``(S*, f*, S̄)`` tuples (the JAX package's
    ``CarryStore.export_state()`` with each carry turned into numpy)
    as ``MatcherService.import_state`` input, carries float32 tensors on
    ``device``. Keys pass through."""
    def conv(items):
        return [(k, pso.carry_from_numpy(c, device)) for k, c in items]
    return conv(exact_items), conv(sim_items)


def _upload(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array (or tensor) on ``device`` without a blocking copy:
    a CUDA upload goes through pinned memory, ``non_blocking``."""
    if torch.is_tensor(x):
        t = x
    else:
        a = np.asarray(x)          # a 0-dim f* stays 0-dim
        t = torch.as_tensor(a if a.flags.c_contiguous else a.copy())
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _CarryHandle:
    """Refcounted reference to one slab row of a :class:`DeviceCarryPool`.

    Stored in :class:`CarryStore` in place of a raw carry tuple: each
    store that holds the handle ``retain``\\ s it, and the row is
    returned to the pool's free list when the last reference is
    ``release``\\ d (eviction, overwrite, or ``clear``). ``materialize``
    yields the ``(S*, f*, S̄)`` view lazily — device slices, no host
    sync."""

    __slots__ = ("pool", "shape", "row", "refs")

    def __init__(self, pool: "DeviceCarryPool", shape: Tuple[int, int],
                 row: int):
        self.pool = pool
        self.shape = shape
        self.row = row
        self.refs = 0

    def retain(self) -> None:
        """Count one more store holding this row."""
        self.refs += 1

    def release(self) -> None:
        """Drop one reference; frees the slab row at zero."""
        self.refs -= 1
        if self.refs <= 0 and self.row >= 0:
            self.pool._free(self.shape, self.row)
            self.row = -1

    def materialize(self) -> tuple:
        """The stored ``(S*, f*, S̄)`` as device slices of the slabs."""
        return self.pool._read(self.shape, self.row)

    def __iter__(self):
        return iter(self.materialize())

    def __len__(self) -> int:
        return 3


class _LazyCarry:
    """Tuple-shaped view of a pooled carry handed out in results.

    Tier-0 hits hand out this view instead of slicing the pool: it
    retains the handle (pinning the slab row even if the store evicts the
    entry later) and, on first access, copies the parts out of the slabs
    (the slabs are written in place, so a slice would change with
    them); the reference drops when the view is garbage-collected."""

    __slots__ = ("_handle", "_parts")

    def __init__(self, handle: "_CarryHandle"):
        handle.retain()
        self._handle = handle
        self._parts = None

    def materialize(self) -> tuple:
        if self._parts is None:
            self._parts = tuple(p.clone() for p in
                                self._handle.materialize())
            self._handle.release()
            self._handle = None
        return self._parts

    def __iter__(self):
        return iter(self.materialize())

    def __len__(self) -> int:
        return 3

    def __getitem__(self, i):
        return self.materialize()[i]

    def __del__(self):
        h = self._handle
        if h is not None:
            try:
                h.release()
            except Exception:  # pragma: no cover - interpreter teardown
                pass


class DeviceCarryPool:
    """Device-resident slab storage for warm-start carries.

    One growable slab triple per padded shape — ``S``: (cap, n, m),
    ``f``: (cap,), ``C``: (cap, n, m), all float32 on ``device`` — and
    refcounted :class:`_CarryHandle` rows:

      * ``put`` writes a row in place (``slab[row].copy_``; a host carry
        is uploaded through pinned memory, non-blocking),
      * ``gather`` turns a batch of handles into stacked launch inputs
        with ONE ``index_select`` per part, with a cached device index
        tensor — never a host sync,
      * rows are recycled through a free list as store evictions release
        their handles.

    Slabs grow geometrically (``torch.cat`` with a zero block), so the
    amortized put cost stays O(row). The pool never syncs to the host.
    """

    def __init__(self, block: int = 32, device="cuda"):
        self.block = max(int(block), 1)
        self.device = torch.device(device)
        self._slabs: Dict[Tuple[int, int], dict] = {}
        self.puts = 0                # rows written
        self.gathers = 0             # batched gathers served
        # steady-state warm drains gather the same row sets every time;
        # caching the device index tensor saves an upload per launch
        self._idx_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _slab_for(self, shape: Tuple[int, int]) -> dict:
        slab = self._slabs.get(shape)
        n, m = shape
        if slab is None:
            cap = self.block
            slab = {"S": self._zeros(cap, n, m), "f": self._zeros(cap),
                    "C": self._zeros(cap, n, m),
                    "free": list(range(cap - 1, -1, -1)), "cap": cap}
            self._slabs[shape] = slab
        if not slab["free"]:
            old = slab["cap"]
            grow = max(old, self.block)
            slab["S"] = torch.cat([slab["S"], self._zeros(grow, n, m)])
            slab["f"] = torch.cat([slab["f"], self._zeros(grow)])
            slab["C"] = torch.cat([slab["C"], self._zeros(grow, n, m)])
            slab["cap"] = old + grow
            slab["free"] = list(range(old + grow - 1, old - 1, -1))
        return slab

    def put(self, carry: tuple) -> _CarryHandle:
        """Write one ``(S*, f*, S̄)`` carry into a slab row (in place) and
        return its (unretained) handle. Accepts device tensors or host
        arrays; the slabs hold float32 and a float32 part is copied
        unrounded."""
        S, f, C = (_upload(x, self.device, torch.float32) for x in carry)
        shape = (int(S.shape[0]), int(S.shape[1]))
        slab = self._slab_for(shape)
        row = slab["free"].pop()
        slab["S"][row].copy_(S)
        slab["f"][row].copy_(f.reshape(()))
        slab["C"][row].copy_(C)
        self.puts += 1
        return _CarryHandle(self, shape, row)

    def gather(self, handles: Sequence[_CarryHandle]) -> tuple:
        """Stacked ``(S, f, C)`` launch inputs for a batch of same-shape
        handles — one ``index_select`` per part, all on the device. The
        result is freshly allocated, so a launch may overwrite it."""
        shape = handles[0].shape
        slab = self._slabs[shape]
        rows = tuple(h.row for h in handles)
        idx = self._idx_cache.get(rows)
        if idx is None:
            idx = _upload(np.asarray(rows, np.int64), self.device)
            self._idx_cache[rows] = idx
            while len(self._idx_cache) > 256:
                self._idx_cache.popitem(last=False)
        self.gathers += 1
        return tuple(torch.index_select(slab[k], 0, idx)
                     for k in ("S", "f", "C"))

    def _read(self, shape: Tuple[int, int], row: int) -> tuple:
        slab = self._slabs[shape]
        return (slab["S"][row], slab["f"][row], slab["C"][row])

    def _free(self, shape: Tuple[int, int], row: int) -> None:
        slab = self._slabs.get(shape)
        if slab is not None:
            slab["free"].append(row)

    @property
    def live_rows(self) -> int:
        """Rows currently referenced by at least one store entry."""
        return sum(s["cap"] - len(s["free"])
                   for s in self._slabs.values())


def _tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _tree_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


class MatcherService:
    """Warm-start online wrapper around Algorithm 1.

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; without
    a card the constructor raises (no silent CPU fallback). Single-device
    by default; pass ``mesh`` + ``axis_names`` to run each launch as the
    distributed matcher on every rank of the mesh (module docstring).
    ``tiered=False`` disables the staged pipeline and restores the uniform
    one-swarm-launch-per-batch drain; ``similarity=False`` keeps the
    pipeline but disables Tier-1 rebases; ``pipelined=False`` restores
    the serial drain (host-staged carries, one fetch per launch).
    ``donate_buffers`` lets each Tier-0/1 revalidation launch rebase its
    freshly gathered carry in place (``pso.revalidate_batch(donate=)``);
    results do not change, and the swarm launches donate nothing.

    ``persist_dir`` (a path; None defers to ``REPRO_PERSIST_DIR``; False
    forces persistence off even when that is set, the cold-restart
    baseline) enables ``save_snapshot`` / ``restore_snapshot`` under
    ``<persist_dir>/snapshots/``, keeping ``snapshot_keep`` snapshots.
    """

    def __init__(self, cfg: Optional[pso.PSOConfig] = None, *,
                 mesh=None, axis_names: Sequence[str] = ("data",),
                 device="cuda",
                 cache_capacity: int = 16, warm_capacity: int = 256,
                 warm_start: bool = True, early_exit: bool = True,
                 n_multiple: int = 8, m_multiple: int = 16,
                 batch_classes: Sequence[int] = (1, 2, 4, 8),
                 tiered: bool = True, similarity: bool = True,
                 sim_capacity: int = 128, sim_index: bool = True,
                 pipelined: bool = True, donate_buffers: bool = True,
                 persist_dir: Union[str, bool, None] = None,
                 snapshot_keep: int = 3):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MatcherService: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        cfg = cfg or pso.PSOConfig()
        if early_exit and not cfg.early_exit:
            cfg = cfg.replace(early_exit=True)
        self.cfg = cfg
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.cache_capacity = max(int(cache_capacity), 1)
        self.warm_start = warm_start
        self.n_multiple = n_multiple
        self.m_multiple = m_multiple
        self.batch_classes = tuple(sorted(set(int(b) for b in batch_classes)))
        if not self.batch_classes or self.batch_classes[0] < 1:
            raise ValueError(f"batch_classes {batch_classes!r}")
        self.tiered = tiered
        self.similarity = similarity
        self.pipelined = bool(pipelined)
        self.donate_buffers = bool(donate_buffers)
        self.stats = ServiceStats()
        self._carries = CarryStore(warm_capacity, sim_capacity, self.stats,
                                   sim_index=sim_index)
        self._pool = DeviceCarryPool(device=self.device)
        # per-bucket pre-finished pad carry, pooled once and pinned so
        # padded warm batches stay all-handle (one-gather launch inputs)
        self._pad_handles: Dict[Tuple[int, int], _CarryHandle] = {}
        self._compiled: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self._pending: List[_PendingRequest] = []
        if persist_dir is None:
            persist_dir = persist.default_persist_dir()
        self.persist_dir = persist_dir if persist_dir else None
        self._ckpt: Optional[CheckpointManager] = None
        if self.persist_dir:
            self._ckpt = CheckpointManager(
                os.path.join(self.persist_dir, "snapshots"),
                async_save=False, keep=snapshot_keep)

    @property
    def warm_capacity(self) -> int:
        """Exact warm-start store capacity (entries)."""
        return self._carries.capacity

    def clear_carries(self) -> None:
        """Drop every stored warm-start carry (exact and similarity)."""
        self._carries.clear()

    @property
    def config_digest(self) -> str:
        """Digest guarding every snapshot of this service: the resolved
        kernel suite, every ``PSOConfig`` field, the bucketing
        parameters, the torch version and the device type. A snapshot
        whose digest differs is skipped on restore."""
        return kernel_backend.config_digest(
            self.cfg,
            extra=("svc-v2", torch.__version__, self.device.type,
                   self.n_multiple, self.m_multiple, self.batch_classes,
                   self.mesh is not None))

    def import_state(self, exact_items, sim_items) -> Tuple[int, int]:
        """Load exported key/carry lists (``CarryStore.export_state``
        order, carries as ``(S*, f*, S̄)`` tuples, e.g. from
        ``store_state_from_numpy``) into this service's store: each
        carry is written into the device pool once. Returns
        ``(n_exact, n_sim)``."""
        return self._carries.import_state(
            [(k, self._pool.put(c)) for k, c in exact_items],
            [(k, self._pool.put(c)) for k, c in sim_items])

    # -- the callable LRU --------------------------------------------------

    def _cache_put(self, cache_key, fn):
        self._compiled[cache_key] = fn
        while len(self._compiled) > self.cache_capacity:
            self._compiled.popitem(last=False)
            self.stats.compile_evictions += 1
        return fn

    def _cache_get(self, cache_key):
        fn = self._compiled.get(cache_key)
        if fn is not None:
            self._compiled.move_to_end(cache_key)
            self.stats.compile_cache_hits += 1
        return fn

    def _count_first_call(self, fn):
        """Wrap a bound callable so its first call shows up in
        ``stats.jit_traces`` (the reference counts its jit traces
        there; the port has nothing to trace, so it counts first
        calls)."""
        fired: List[int] = []

        def wrapped(*args, **kw):
            if not fired:
                fired.append(1)
                self.stats.jit_traces += 1
            return fn(*args, **kw)

        return wrapped

    def _resolve_executable(self, cache_key, build):
        """LRU lookup; a miss binds a fresh callable with ``build``."""
        fn = self._cache_get(cache_key)
        if fn is not None:
            return fn
        self.stats.compile_cache_misses += 1
        return self._cache_put(cache_key, self._count_first_call(build()))

    def _executable(self, bucket: Tuple[int, int]):
        """Single-problem swarm callable for one shape bucket:
        ``fn(Q, G, mask, carry0, stream)``."""
        cfg = self.cfg

        def build():
            if self.mesh is not None:
                dist_fn = build_distributed_match(bucket, self.mesh, cfg,
                                                  self.axis_names)
                D = mesh_lib.mesh_axes(self.mesh, self.axis_names).size

                def fn(Q, G, mask, carry0, stream):
                    return dist_fn(shard_streams(stream, D), Q, G, mask,
                                   carry0)
                return fn

            def fn(Q, G, mask, carry0, stream):
                return pso.match(Q, G, mask, cfg, carry0, stream=stream)
            return fn

        return self._resolve_executable(bucket, build)

    def _executable_batch(self, bucket: Tuple[int, int], bclass: int):
        """One swarm callable per (shape bucket, padded batch class):
        ``fn(streams, Qb, Gb, maskb, carry0)``."""
        cfg = self.cfg

        def build():
            if self.mesh is not None:
                return build_distributed_match_batch(
                    bucket, self.mesh, cfg, self.axis_names, bclass)

            def fn(streams, Qb, Gb, maskb, carry0):
                return pso.match_batch(Qb, Gb, maskb, cfg, carry0,
                                       streams=streams)
            return fn

        return self._resolve_executable((bucket, bclass), build)

    def _executable_reval(self, bucket: Tuple[int, int], bclass: int):
        """Tier-0/1 revalidation callable (no epochs, no draws):
        ``fn(Qb, Gb, maskb, carry0)``."""
        cfg = self.cfg
        donate = self.donate_buffers

        def build():
            if self.mesh is not None:
                return build_distributed_revalidate_batch(
                    bucket, self.mesh, cfg, self.axis_names, bclass,
                    donate=donate)

            def fn(Qb, Gb, maskb, carry0):
                return pso.revalidate_batch(Qb, Gb, maskb, cfg, carry0,
                                            donate=donate)
            return fn

        return self._resolve_executable((bucket, bclass, "reval"), build)

    def _batch_class(self, k: int) -> int:
        """Smallest padded batch class holding k problems."""
        for c in self.batch_classes:
            if c >= k:
                return c
        return self.batch_classes[-1]

    @staticmethod
    def _warm_key(req: _PendingRequest) -> Tuple:
        """Exact warm starts are only valid for the *same* problem, so the
        key always includes the content digest ``_prepare`` computed; the
        request's ``workload_key`` additionally scopes entries to the
        caller's (workload, platform-state) naming."""
        return (req.workload_key, req.Qp.shape[0], req.Gp.shape[0],
                req.cdigest)

    def _get_carry(self, warm_key):
        if not self.warm_start:
            self.stats.warm_misses += 1
            return None, False
        return self._carries.get(warm_key)

    def _put_carry(self, warm_key, carry):
        if self.warm_start:
            self._carries.put(warm_key, carry)

    def _store_result_carries(self, req: _PendingRequest, warm_key,
                              res: MatchResult, dev_carry) -> None:
        """Store a launch's still-on-device ``(S*, f*, S̄)`` under the
        exact key (one pool row), and — when the call served a decision
        on a known platform state — under the similarity key too."""
        if not self.warm_start:
            return
        stored = self._pool.put(dev_carry)
        self._put_carry(warm_key, stored)
        if self.similarity and res.found and req.engine_sig is not None:
            self._carries.put_similar(req.qdigest, req.bucket,
                                      req.engine_sig, stored)

    # -- snapshots ---------------------------------------------------------

    def save_snapshot(self, step: Optional[int] = None,
                      extra: Optional[Dict] = None) -> int:
        """Persist the service's warm state as one atomic checkpoint.

        Saved: every :class:`CarryStore` entry (exact and similarity, in
        LRU order; one ``.npy`` leaf per carry part) and the prune-sweep
        calibration counters (``prune_problems`` / ``prune_sweeps``, which
        the scheduler's cost model reads). The pooled carries reach the
        host with ONE blocking transfer for the whole snapshot
        (``persist.to_host``). Not saved: the callable LRU, transient
        stats, pending requests. ``extra`` (JSON-serializable) rides in the
        snapshot's metadata; the scheduler keeps its tier-predictor
        posteriors there. Entries whose keys cannot be encoded are skipped
        and counted (``snapshot_skipped_keys``). Returns the committed
        step. Requires ``persist_dir``. On a mesh every rank calls it:
        each picks the step, a barrier, then the mesh's first rank writes
        (every rank holds the same store) and a second barrier holds the
        others until the step is committed."""
        if self._ckpt is None:
            raise RuntimeError("save_snapshot needs persist_dir "
                               "(or REPRO_PERSIST_DIR)")
        exact_items, sim_items = self._carries.export_state()
        keys: Dict[str, list] = {"exact": [], "sim": []}
        leaves: Dict[str, object] = {}
        for store, items in (("exact", exact_items), ("sim", sim_items)):
            carries = []
            for k, c in items:
                try:
                    keys[store].append(persist.encode_key(k))
                except TypeError:
                    self.stats.snapshot_skipped_keys += 1
                    continue
                carries.append(self._carry_tuple(c))
            leaves.update(persist.named_leaves(store, carries))
        arrays = persist.to_host(leaves)
        # a flat checkpoint must hold a leaf for restore_flat to see it,
        # even with no carries stored yet
        arrays["snapshot.marker"] = np.zeros((), np.int8)
        extras = {
            "format_version": persist.SNAPSHOT_VERSION,
            "config_digest": self.config_digest,
            "exact_keys": keys["exact"],
            "sim_keys": keys["sim"],
            "calibration": {
                "prune_problems": int(self.stats.prune_problems),
                "prune_sweeps": int(self.stats.prune_sweeps),
            },
            "extra": extra or {},
        }
        if step is None:
            latest = self._ckpt.latest_step()
            step = 0 if latest is None else latest + 1
        if self.mesh is not None:
            mesh_lib.barrier()   # every rank has read the step: now write
        if self.mesh is None or mesh_lib.mesh_writer(self.mesh):
            self._ckpt.save(step, arrays, extras=extras)
            self._ckpt.wait()
        if self.mesh is not None:
            mesh_lib.barrier()
        self.stats.snapshot_saves += 1
        return step

    def restore_snapshot(self, step: Optional[int] = None
                         ) -> Optional[Dict]:
        """Load the newest (or ``step``-th) snapshot into this service.

        Checked before anything is touched: the snapshot's format version
        and ``config_digest`` must be this service's; a snapshot written
        under another kernel suite, ``PSOConfig``, bucketing, torch
        version or device type is counted in ``snapshot_stale_skipped``
        and ignored. On success the carries go back into the device pool
        on the service's own device (one row an entry, uploaded without a
        blocking copy), the :class:`CarryStore` is rebuilt in recency
        order (the similarity index with it), the calibration counters
        are re-seeded, and the snapshot's ``extra`` dict is returned
        (``{}`` when none was stored). Returns None when nothing valid
        exists to restore. Requires ``persist_dir``."""
        if self._ckpt is None:
            raise RuntimeError("restore_snapshot needs persist_dir "
                               "(or REPRO_PERSIST_DIR)")
        try:
            arrays, extras = self._ckpt.restore_flat(step)
        except (OSError, ValueError, KeyError):
            arrays, extras = None, None
        if arrays is None:
            return None
        if extras.get("format_version") != persist.SNAPSHOT_VERSION or \
                extras.get("config_digest") != self.config_digest:
            self.stats.snapshot_stale_skipped += 1
            return None
        exact_keys = [persist.decode_key(k) for k in extras["exact_keys"]]
        sim_keys = [persist.decode_key(k) for k in extras["sim_keys"]]
        exact = persist.carries_from_leaves("exact", arrays, len(exact_keys))
        sim = persist.carries_from_leaves("sim", arrays, len(sim_keys))
        n_exact, n_sim = self.import_state(list(zip(exact_keys, exact)),
                                           list(zip(sim_keys, sim)))
        calib = extras.get("calibration", {})
        self.stats.prune_problems += int(calib.get("prune_problems", 0))
        self.stats.prune_sweeps += int(calib.get("prune_sweeps", 0))
        self.stats.snapshot_restores += 1
        self.stats.restored_carries += n_exact
        self.stats.restored_sim_entries += n_sim
        return extras.get("extra", {})

    def verify_snapshot_roundtrip(self, step: Optional[int] = None
                                  ) -> bool:
        """Save a snapshot, restore it into a fresh twin service with this
        one's configuration, and compare the warm state bit for bit: both
        stores' keys in LRU order, every carry part (dtype, shape and
        bytes) and the calibration counters. Raises ``AssertionError``
        naming the first difference; returns True when the round trip is
        exact. Requires ``persist_dir``."""
        step = self.save_snapshot(step=step)
        twin = MatcherService(
            self.cfg, mesh=self.mesh, axis_names=self.axis_names,
            device=self.device,
            cache_capacity=self.cache_capacity,
            warm_capacity=self._carries.capacity,
            warm_start=self.warm_start, n_multiple=self.n_multiple,
            m_multiple=self.m_multiple, batch_classes=self.batch_classes,
            tiered=self.tiered, similarity=self.similarity,
            sim_capacity=self._carries.sim_capacity,
            sim_index=self._carries.sim_index, pipelined=self.pipelined,
            donate_buffers=self.donate_buffers,
            persist_dir=self.persist_dir)
        restored = twin.restore_snapshot(step=step)
        assert restored is not None, \
            "snapshot round trip: restore rejected its own snapshot"

        def leaves(svc):
            exact, sim = svc._carries.export_state()
            return [(store, [k for k, _ in items],
                     persist.to_host(persist.named_leaves(
                         store, [svc._carry_tuple(c) for _, c in items])))
                    for store, items in (("exact", exact), ("sim", sim))]

        for (store, mk, mine), (_, tk, theirs) in zip(leaves(self),
                                                      leaves(twin)):
            assert mk == tk, f"snapshot round trip: {store} store keys " \
                             f"diverged"
            assert list(mine) == list(theirs), \
                f"snapshot round trip: {store} carry leaves diverged"
            for name, a in mine.items():
                b = theirs[name]
                assert a.dtype == b.dtype and a.shape == b.shape \
                    and a.tobytes() == b.tobytes(), \
                    f"snapshot round trip: {store} leaf {name} not " \
                    f"bitwise equal"
        assert (twin.stats.prune_problems, twin.stats.prune_sweeps) == \
            (self.stats.prune_problems, self.stats.prune_sweeps), \
            "snapshot round trip: calibration counters diverged"
        return True

    # -- matching ----------------------------------------------------------

    def _prepare(self, query: Graph, target: Graph, key, workload_key,
                 engine_sig: Optional[bytes] = None) -> _PendingRequest:
        """Relabel, bucket and pad a problem on the host; the launch
        uploads Qp/Gp/maskp once.

        ``key`` is the request's draw stream (seed 0 if None).
        ``engine_sig`` (the free-engine bitmask, see
        ``accel.target_graph.free_engine_signature``) keys the similarity
        store; when omitted it is recovered from a ``(name, sig)``-style
        ``workload_key`` whose last element is bytes."""
        if key is None:
            key = 0
        if isinstance(key, torch.Generator):
            raise TypeError("a service request's key is a seed or a "
                            "callable of the epoch: a pad slot shares its "
                            "request's stream, which a generator's state "
                            "cannot be")
        if engine_sig is None and isinstance(workload_key, tuple) \
                and workload_key and isinstance(workload_key[-1], bytes):
            engine_sig = workload_key[-1]
        q, order = topological_relabel(query)
        n, m = q.n, target.n
        mask = compatibility_mask(q, target)
        bucket = shape_bucket(n, m, self.n_multiple, self.m_multiple)
        Qp, Gp, maskp = pad_problem(q.adj, target.adj, mask, *bucket)
        # one hashing pass yields both keys: the query-only digest (the
        # similarity key) is a prefix state of the full content digest
        h = hashlib.sha1(np.ascontiguousarray(Qp).tobytes())
        qdigest = h.hexdigest()
        h.update(np.ascontiguousarray(Gp).tobytes())
        h.update(np.ascontiguousarray(maskp).tobytes())
        return _PendingRequest(key=key, workload_key=workload_key,
                               order=order, crop=(n, m), bucket=bucket,
                               Qp=Qp, Gp=Gp, maskp=maskp,
                               engine_sig=engine_sig, qdigest=qdigest,
                               cdigest=h.hexdigest())

    def _note_prune(self, problems: int, sweeps: int) -> None:
        """Account the fused pre-prune work a launch reported."""
        if self.cfg.prune_mask and problems > 0:
            self.stats.prune_problems += problems
            self.stats.prune_sweeps += int(sweeps)

    def _tiers_active(self) -> bool:
        """Tier 0/1 only exist when the fast path they batch is on."""
        return (self.tiered and self.warm_start
                and self.cfg.early_exit and self.cfg.carry_fastpath)

    # -- device residency --------------------------------------------------

    def _sync_fetch(self, tree):
        """THE blocking device→host transfer of the drain pipeline.

        Copies every tensor leaf of ``tree`` (typically every pending
        launch's outputs) into pinned host memory with ``non_blocking``
        copies, records one event and waits on it once — the only wait,
        and the only place that lifts a ``torch.cuda`` sync-debug mode.
        Records the census: ``host_syncs`` (count),
        ``host_bytes_transferred`` (payload) and ``host_sync_wall_s``
        (time blocked). Leaves come back as numpy arrays."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            def to_pinned(x):
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x.detach(), non_blocking=True)
                return h

            staged = _tree_map(to_pinned, tree)
            ev = torch.cuda.Event()
            ev.record()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                ev.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            host = _tree_map(lambda h: h.numpy(), staged)
        else:
            host = _tree_map(lambda x: x.detach().numpy().copy(), tree)
        self.stats.host_syncs += 1
        self.stats.host_sync_wall_s += time.perf_counter() - t0
        self.stats.host_bytes_transferred += int(sum(
            getattr(leaf, "nbytes", 0) for leaf in _tree_leaves(host)))
        return host

    @staticmethod
    def _fetch_tree(rec: "_LaunchRecord"):
        """The subset of a launch's outputs its apply step reads on the
        host. Tier-0 revalidation never looks at the rebased ``S*``/``S̄``
        planes host-side (hit carries stay pooled), so they stay out of
        every warm fetch. Swarm launches fetch every tensor output."""
        if rec.kind != "reval":
            return {k: v for k, v in rec.outs.items() if torch.is_tensor(v)}
        keys = (("mapping", "ok", "f_carry", "prune_sweeps")
                if rec.tier == 0 else
                ("mapping", "ok_rebase", "fitness", "S_star", "S_bar",
                 "prune_sweeps"))
        return {k: rec.outs[k] for k in keys}

    @staticmethod
    def _carry_tuple(carry) -> tuple:
        """A stored carry as its ``(S*, f*, S̄)`` tuple: device-pool
        handles and lazy result views are materialized (device slices,
        no host sync); plain tuples pass through."""
        if isinstance(carry, (_CarryHandle, _LazyCarry)):
            return carry.materialize()
        return carry

    def _stack_carries(self, carries: List) -> tuple:
        """Stacked ``(B, ...)`` carry inputs for one launch, freshly
        allocated on the device (a donating launch may overwrite them).

        All-handle same-shape batches (the warm steady state) take the
        pool's one-``index_select``-per-part gather; mixed batches (cold
        priors, rebased seeds, pad fillers) stack the materialized parts
        on the device. Nothing round-trips through the host.

        The ``pipelined=False`` arm instead keeps the reference's legacy
        host staging: each carry part is pulled to the host and
        re-stacked with numpy. Those transfers are charged to the census
        here (one sync per tensor part)."""
        if not self.pipelined:
            mats = [self._carry_tuple(c) for c in carries]
            stacked = []
            for i in range(3):
                parts = []
                for mat in mats:
                    p = mat[i]
                    if torch.is_tensor(p):
                        t0 = time.perf_counter()
                        p = p.detach().cpu().numpy()
                        self.stats.host_syncs += 1
                        self.stats.host_sync_wall_s += \
                            time.perf_counter() - t0
                        self.stats.host_bytes_transferred += int(p.nbytes)
                    parts.append(np.asarray(p, np.float32))
                stacked.append(_upload(np.stack(parts), self.device))
            return tuple(stacked)
        if all(isinstance(c, _CarryHandle) for c in carries) and \
                len({c.shape for c in carries}) == 1:
            return self._pool.gather(carries)
        mats = [self._carry_tuple(c) for c in carries]
        return tuple(torch.stack([_upload(m[i], self.device, torch.float32)
                                  for m in mats])
                     for i in range(3))

    def _upload_problems(self, reqs: List[_PendingRequest]):
        """Stacked (Qb, Gb, maskb) of a launch on the device."""
        return tuple(_upload(np.stack([getattr(r, k) for r in reqs]),
                             self.device)
                     for k in ("Qp", "Gp", "maskp"))

    def _cold_carry(self, req: _PendingRequest) -> tuple:
        return pso.default_carry(_upload(req.maskp, self.device))

    def match(self, query: Graph, target: Graph, key=None,
              workload_key=None,
              engine_sig: Optional[bytes] = None) -> ServiceMatchResult:
        """Match ``query`` onto ``target`` through the service caches.

        ``key`` is the request's draw stream (seed 0 if None);
        ``workload_key`` names the (workload, platform-state) class for
        warm-start scoping — e.g. ``(task_name, free_engine_signature)``.
        A single call serves warm repeats through the in-launch carry
        fast path (Tier 0) and attempts a Tier-1 rebase on an exact-carry
        MISS with a similar stored platform state; a failed exact carry
        goes straight to the swarm (batch through ``submit``/``drain`` for
        the full pipeline).
        """
        t0 = time.perf_counter()
        self.stats.calls += 1
        self.stats.epochs_budgeted += self.cfg.epochs
        req = self._prepare(query, target, key, workload_key, engine_sig)
        bucket = req.bucket
        order, (n, m) = req.order, req.crop

        warm_key = self._warm_key(req)
        carry0, warm_hit = self._get_carry(warm_key)
        if carry0 is not None:
            self.stats.tier0.checked += 1

        # Tier 1 (single-call path): exact miss, but a similar platform
        # state is stored — revalidate its rebased carry before swarming.
        seed = None
        if carry0 is None and self._tiers_active() and self.similarity \
                and req.engine_sig is not None:
            item = _PipelineItem(req=req, ticket=0, warm_key=warm_key,
                                 carry=None, warm_hit=False, t0=t0)
            nb = self._lookup_neighbor(item)
            if nb is not None:
                residual = self._launch_revalidate(bucket, [item], [nb],
                                                   tier=1)
                if not residual:
                    res = item.result
                    res.latency_s = time.perf_counter() - t0
                    return res
                seed = item.seed

        hits_before = self.stats.compile_cache_hits
        fn = self._executable(bucket)
        compile_hit = self.stats.compile_cache_hits > hits_before

        Qp, Gp, maskp = (_upload(x, self.device)
                         for x in (req.Qp, req.Gp, req.maskp))
        if carry0 is None:
            carry0 = seed if seed is not None else pso.default_carry(maskp)
        carry0 = tuple(_upload(x, self.device, torch.float32)
                       for x in self._carry_tuple(carry0))
        outs = fn(Qp, Gp, maskp, carry0, req.key)
        self.stats.host_syncs += outs["host_syncs"]

        # the controller state stays on the device for the store; the
        # result itself resolves through ONE counted fetch
        dev_carry = (outs["S_star"], outs["f_star"], outs["S_bar"])
        host = self._sync_fetch({k: v for k, v in outs.items()
                                 if torch.is_tensor(v)})
        host["host_syncs"] = outs["host_syncs"]
        base = collect_result(host, order=order, crop=(n, m))
        res = ServiceMatchResult(**{f.name: getattr(base, f.name)
                                    for f in dataclasses.fields(MatchResult)})
        self._store_result_carries(req, warm_key, res, dev_carry)
        self.stats.epochs_run += res.epochs_run
        self._note_prune(1, res.prune_sweeps)
        if res.found:
            self.stats.found += 1
        if res.carry_verified:
            # the in-launch fast path IS Tier 0 for a single call
            self.stats.carry_fastpath_hits += 1
            self.stats.tier0.hits += 1
            res.tier = 0
        else:
            self.stats.tier2.launches += 1
            self.stats.epoch_fused_launches += 1
            self.stats.epoch_finish_launches += 1
            self.stats.epoch_finish_problems += 1
            self.stats.tier2.checked += 1
            if res.found:
                self.stats.tier2.hits += 1
            res.tier = 2
        res.bucket = bucket
        res.compile_cache_hit = compile_hit
        res.warm_hit = warm_hit
        res.latency_s = time.perf_counter() - t0
        return res

    # -- request coalescing ------------------------------------------------

    def submit(self, query: Graph, target: Graph, key=None,
               workload_key=None, engine_sig: Optional[bytes] = None) -> int:
        """Queue a problem for the next ``drain``; returns its ticket
        index into the results list ``drain`` will return."""
        self._pending.append(self._prepare(query, target, key, workload_key,
                                           engine_sig))
        return len(self._pending) - 1

    @property
    def pending(self) -> int:
        """Number of submitted problems waiting for the next drain."""
        return len(self._pending)

    def drain(self) -> List[ServiceMatchResult]:
        """Flush the pending queue through the tiered pipeline.

        Same-bucket requests form one pipeline group: Tier 0 revalidates
        every stored carry in one cheap launch, Tier 1 rebases similar
        carries for the misses, and only the residual requests launch the
        Tier-2 swarm (chunked to batch classes). Results come back in
        submission order; each request's ``latency_s`` is the wall time
        of the launches that actually served it.

        With ``pipelined=True`` (the default) each tier dispatches its
        launches for EVERY bucket group before anything is fetched, and
        each stage resolves through one fetch — an all-warm drain costs
        exactly one blocking host sync. ``pipelined=False`` restores the
        serial walk: carries staged through host numpy (one sync per
        carry part) and one fetch per launch.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return []
        self.stats.drains += 1
        results: List[Optional[ServiceMatchResult]] = [None] * len(pending)
        groups: "OrderedDict[Tuple[int, int], List[int]]" = OrderedDict()
        for i, req in enumerate(pending):
            groups.setdefault(req.bucket, []).append(i)
        if self._tiers_active() and self.pipelined:
            self._drain_pipelined(pending, groups, results)
            return results  # type: ignore[return-value]
        max_chunk = self.batch_classes[-1]
        for bucket, idxs in groups.items():
            reqs = [pending[i] for i in idxs]
            if self._tiers_active():
                self._run_pipeline(bucket, reqs, idxs, results)
            else:
                for pos in range(0, len(idxs), max_chunk):
                    chunk = idxs[pos:pos + max_chunk]
                    self._launch_batch_legacy(
                        bucket, [pending[i] for i in chunk], chunk, results)
        return results  # type: ignore[return-value]

    def match_many(self, problems: Sequence[Tuple[Graph, Graph]],
                   keys: Optional[Sequence] = None,
                   workload_keys: Optional[Sequence] = None,
                   engine_sigs: Optional[Sequence[Optional[bytes]]] = None
                   ) -> List[ServiceMatchResult]:
        """Submit a burst of (query, target) problems and drain them
        through the tiered pipeline."""
        for i, (q, g) in enumerate(problems):
            self.submit(q, g,
                        key=None if keys is None else keys[i],
                        workload_key=(None if workload_keys is None
                                      else workload_keys[i]),
                        engine_sig=(None if engine_sigs is None
                                    else engine_sigs[i]))
        return self.drain()

    # -- the tiered pipeline ----------------------------------------------

    def _intake(self, reqs: List[_PendingRequest], tickets: List[int]
                ) -> List[_PipelineItem]:
        """Shared per-request intake for every drain path: call/budget
        accounting, exact-carry lookup, group coalescing stats."""
        t_start = time.perf_counter()
        items: List[_PipelineItem] = []
        for req, ticket in zip(reqs, tickets):
            self.stats.calls += 1
            self.stats.epochs_budgeted += self.cfg.epochs
            wk = self._warm_key(req)
            carry, hit = self._get_carry(wk)
            items.append(_PipelineItem(req=req, ticket=ticket, warm_key=wk,
                                       carry=carry, warm_hit=hit,
                                       t0=t_start))
        if len(items) > 1:
            self.stats.coalesced_requests += len(items)
        return items

    def _run_pipeline(self, bucket, reqs: List[_PendingRequest],
                      tickets: List[int], results: List) -> None:
        """Revalidate → similarity-rebase → swarm for one bucket group,
        one fetch per launch (the serial arm)."""
        items = self._intake(reqs, tickets)
        max_chunk = self.batch_classes[-1]

        # ---- Tier 0: batched revalidation of every stored carry ----
        residual: List[_PipelineItem] = [it for it in items
                                         if it.carry is None]
        cand = [it for it in items if it.carry is not None]
        for pos in range(0, len(cand), max_chunk):
            chunk = cand[pos:pos + max_chunk]
            residual.extend(self._launch_revalidate(
                bucket, chunk, [it.carry for it in chunk], tier=0))

        # ---- Tier 1: rebase the nearest similar carry for the misses ----
        if self.similarity and residual:
            t1_items, t1_carries = [], []
            for it in residual:
                nb = self._lookup_neighbor(it)
                if nb is not None:
                    t1_items.append(it)
                    t1_carries.append(nb)
            for pos in range(0, len(t1_items), max_chunk):
                self._launch_revalidate(
                    bucket, t1_items[pos:pos + max_chunk],
                    t1_carries[pos:pos + max_chunk], tier=1)

        # ---- Tier 2: swarm sized to the residual (hard) subset ----
        residual = [it for it in items if it.result is None]
        for pos in range(0, len(residual), max_chunk):
            self._launch_swarm(bucket, residual[pos:pos + max_chunk])

        for it in items:
            it.result.latency_s = it.latency_s
            results[it.ticket] = it.result

    def _drain_pipelined(self, pending: List[_PendingRequest],
                         groups: "OrderedDict[Tuple[int, int], List[int]]",
                         results: List) -> None:
        """Dispatch-then-fetch drain: every bucket group's launches for
        one tier are enqueued before ANY of them is fetched, then the
        whole stage resolves through a single fetch (``_apply_all``).
        Results and stored carries are bitwise those of the serial walk:
        store keys embed the bucket, so groups never interact, and within
        a group the tier order and miss order are preserved."""
        max_chunk = self.batch_classes[-1]
        # ---- Tier 0: dispatch every group's revalidation launches ----
        recs: List[_LaunchRecord] = []
        state = []                 # (bucket, items, residual) per group
        for bucket, idxs in groups.items():
            items = self._intake([pending[i] for i in idxs], idxs)
            residual = [it for it in items if it.carry is None]
            cand = [it for it in items if it.carry is not None]
            for pos in range(0, len(cand), max_chunk):
                chunk = cand[pos:pos + max_chunk]
                recs.append(self._dispatch_revalidate(
                    bucket, chunk, [it.carry for it in chunk], tier=0,
                    miss_sink=residual))
            state.append((bucket, items, residual))
        self._apply_all(recs)

        # ---- Tier 1: rebase lookups + dispatches across all groups ----
        recs = []
        for bucket, items, residual in state:
            if not (self.similarity and residual):
                continue
            t1_items, t1_carries = [], []
            for it in residual:
                nb = self._lookup_neighbor(it)
                if nb is not None:
                    t1_items.append(it)
                    t1_carries.append(nb)
            for pos in range(0, len(t1_items), max_chunk):
                recs.append(self._dispatch_revalidate(
                    bucket, t1_items[pos:pos + max_chunk],
                    t1_carries[pos:pos + max_chunk], tier=1,
                    miss_sink=[]))
        self._apply_all(recs)

        # ---- Tier 2: swarm the residual of every group ----
        recs = []
        for bucket, items, _ in state:
            residual = [it for it in items if it.result is None]
            for pos in range(0, len(residual), max_chunk):
                recs.append(self._dispatch_swarm(
                    bucket, residual[pos:pos + max_chunk]))
        self._apply_all(recs)

        for _, items, _ in state:
            for it in items:
                it.result.latency_s = it.latency_s
                results[it.ticket] = it.result

    def _apply_all(self, recs: List[_LaunchRecord]) -> None:
        """Resolve one pipeline stage: ONE fetch covering every
        dispatched launch's outputs, then the per-launch applies in
        dispatch order."""
        if not recs:
            return
        hosts = self._sync_fetch([self._fetch_tree(rec) for rec in recs])
        for rec, host in zip(recs, hosts):
            if rec.kind == "reval":
                self._apply_revalidate(rec, host)
            else:
                self._apply_swarm(rec, host)

    def _lookup_neighbor(self, item: _PipelineItem) -> Optional[tuple]:
        """Similarity-store probe for one Tier-0 miss; returns the carry
        of the nearest stored platform state, or None."""
        req = item.req
        if req.engine_sig is None:
            return None
        self.stats.sim_lookups += 1
        nb = self._carries.nearest(
            req.qdigest, req.bucket, req.engine_sig,
            # the exact carry already failed revalidation — don't retry it
            exclude_sig=req.engine_sig if item.carry is not None else None)
        if nb is None:
            return None
        self.stats.sim_neighbor_hits += 1
        return nb[1]

    def _launch_revalidate(self, bucket, items: List[_PipelineItem],
                           carries: List[tuple], tier: int
                           ) -> List[_PipelineItem]:
        """One *serial* Tier-0/1 launch: dispatch, then a fetch of just
        this launch's outputs. Hits get their result attached; misses are
        returned for the next tier (Tier-1 misses keep the rebased carry,
        f* reset to -inf, as their swarm seed)."""
        misses: List[_PipelineItem] = []
        rec = self._dispatch_revalidate(bucket, items, carries, tier,
                                        miss_sink=misses)
        self._apply_revalidate(rec, self._sync_fetch(self._fetch_tree(rec)))
        return misses

    def _dispatch_revalidate(self, bucket, items: List[_PipelineItem],
                             carries: List[tuple], tier: int,
                             miss_sink: List) -> _LaunchRecord:
        """Enqueue one Tier-0/1 revalidation launch (no host sync): pad
        the batch, stack the carries on the device, launch."""
        t0 = time.perf_counter()
        B = len(items)
        bclass = self._batch_class(B)
        tstats = self.stats.tier0 if tier == 0 else self.stats.tier1

        hits_before = self.stats.compile_cache_hits
        fn = self._executable_reval(bucket, bclass)
        compile_hit = self.stats.compile_cache_hits > hits_before

        reqs = [it.req for it in items]
        stored = list(carries)
        padded, carries = list(reqs), list(carries)
        if bclass > B:
            pad_req, pad_carry = self._pad_slot(bucket, reqs[0], carries[0])
            padded += [pad_req] * (bclass - B)
            carries += [pad_carry] * (bclass - B)
        Qb, Gb, maskb = self._upload_problems(padded)
        carry0 = self._stack_carries(carries)
        if self.donate_buffers:
            self.stats.donated_launches += 1

        outs = fn(Qb, Gb, maskb, carry0)
        tstats.launches += 1
        tstats.checked += B
        return _LaunchRecord(kind="reval", bucket=bucket, items=items,
                             tier=tier, B=B, bclass=bclass,
                             compile_hit=compile_hit, outs=outs,
                             carries=stored, miss_sink=miss_sink, t0=t0)

    def _apply_revalidate(self, rec: _LaunchRecord, host: dict) -> None:
        """Consume one fetched revalidation launch: attach hit results,
        append misses to the record's sink (with their Tier-2 seeds),
        refresh stores. Array reads come from ``host`` or stay on the
        device — this path never blocks."""
        tier, B, items = rec.tier, rec.B, rec.items
        bucket, carries = rec.bucket, rec.carries
        tstats = self.stats.tier0 if tier == 0 else self.stats.tier1
        # Tier 0 re-validates this problem's own carry (carried-f* gate);
        # Tier 1 additionally requires the rebased projection to clear the
        # fitness bound on THIS problem (stored f* isn't transferable)
        ok = host["ok" if tier == 0 else "ok_rebase"]
        maps = host["mapping"]
        fits = host.get("fitness")
        S_rb = host.get("S_star")
        S_bar_rb = host.get("S_bar")
        f_carry = host.get("f_carry")
        sweeps = host["prune_sweeps"].reshape(-1)
        self._note_prune(B, int(sweeps[:B].sum()))
        done = time.perf_counter()

        tstats.wall_s += done - rec.t0
        for j, it in enumerate(items):
            it.latency_s = done - it.t0
            if not ok[j]:
                if tier == 1:
                    # the rebased controller state seeds the Tier-2
                    # swarm, kept on the device (slices of the outputs)
                    it.seed = (rec.outs["S_star"][j],
                               np.float32(-np.inf), rec.outs["S_bar"][j])
                rec.miss_sink.append(it)
                continue
            tstats.hits += 1
            self.stats.carry_fastpath_hits += 1
            self.stats.found += 1
            if tier == 0:
                # the stored carry revalidated: it stays in the store
                # untouched; its f* comes from the output echo, and the
                # result's carry is a lazy view of the pool row
                carry = (_LazyCarry(carries[j])
                         if isinstance(carries[j], _CarryHandle)
                         else self._carry_tuple(carries[j]))
                f_res = float(f_carry[j])
            else:
                carry = (S_rb[j], fits[j], S_bar_rb[j])
                f_res = float(fits[j])
                if self.warm_start:
                    stored = self._pool.put(
                        (rec.outs["S_star"][j], rec.outs["fitness"][j],
                         rec.outs["S_bar"][j]))
                    self._put_carry(it.warm_key, stored)
                    if it.req.engine_sig is not None:
                        self._carries.put_similar(it.req.qdigest, bucket,
                                                  it.req.engine_sig,
                                                  stored)
            it.result = self._revalidated_result(
                it, maps[j], f_res, carry, tier=tier, batch=B,
                compile_hit=rec.compile_hit, prune_sweeps=int(sweeps[j]))

    def _revalidated_result(self, item: _PipelineItem, M_c: np.ndarray,
                            f_res: float, carry, *, tier: int, batch: int,
                            compile_hit: bool, prune_sweeps: int = 0
                            ) -> ServiceMatchResult:
        """Host-side result for a request served by revalidation alone —
        the 0-epoch equivalent of what ``collect_result`` produces when
        the in-launch fast path skipped every epoch."""
        req, cfg = item.req, self.cfg
        n, m = req.crop
        M = np.asarray(M_c)[:n, :m]
        unperm = np.empty_like(M)
        unperm[req.order, :] = M
        return ServiceMatchResult(
            mapping=unperm,
            feasible_count=0,
            f_star=f_res,
            f_star_trace=np.full((cfg.epochs, cfg.inner_steps), f_res,
                                 np.float32),
            all_mappings=np.zeros((0, n, m), np.uint8),
            all_feasible=np.zeros((0,), bool),
            all_fitness=np.zeros((0,), np.float32),
            carry=carry, epochs_run=0, carry_verified=True,
            prune_sweeps=prune_sweeps,
            bucket=req.bucket, compile_cache_hit=compile_hit,
            warm_hit=item.warm_hit, batch_size=batch,
            coalesced=batch > 1, tier=tier)

    # -- batch launches ----------------------------------------------------

    def _pad_slot(self, bucket, like: _PendingRequest, like_carry
                  ) -> Tuple[_PendingRequest, tuple]:
        """Pad filler for a batch launch: a trivial problem whose carry
        re-validates in epoch 0, so ``scan_epochs_batch`` freezes the pad
        slots immediately. It takes the draw stream of the request it
        copies. Falls back to replicating slot 0's problem AND carry for
        the degenerate n_pad > m_pad buckets where no injective trivial
        mask exists."""
        n_pad, m_pad = bucket
        if m_pad < n_pad:
            return like, like_carry
        Qp = np.zeros((n_pad, n_pad), dtype=like.Qp.dtype)
        Gp = np.zeros((m_pad, m_pad), dtype=like.Gp.dtype)
        maskp = np.zeros((n_pad, m_pad), dtype=like.maskp.dtype)
        idx = np.arange(n_pad)
        maskp[idx, idx] = 1
        carry = self._pad_handles.get(bucket)
        if carry is None:
            S_id = np.zeros((n_pad, m_pad), np.float32)
            S_id[idx, idx] = 1.0
            # f* = +inf clears ANY early_exit_fitness bound, so the pad
            # slot is pre-finished regardless of the configured threshold
            carry = self._pool.put((S_id, np.float32(np.inf), S_id))
            carry.retain()     # pinned: pads recur on every drain
            self._pad_handles[bucket] = carry
        req = _PendingRequest(key=like.key, workload_key=None,
                              order=np.arange(n_pad),
                              crop=(n_pad, m_pad), bucket=bucket,
                              Qp=Qp, Gp=Gp, maskp=maskp)
        return req, carry

    def _launch_swarm(self, bucket, items: List[_PipelineItem]) -> None:
        """One *serial* Tier-2 swarm launch: dispatch, then a fetch of
        just this launch's outputs."""
        rec = self._dispatch_swarm(bucket, items)
        self._apply_swarm(rec, self._sync_fetch(self._fetch_tree(rec)))

    def _dispatch_swarm(self, bucket, items: List[_PipelineItem]
                        ) -> _LaunchRecord:
        """Launch one Tier-2 swarm over items whose carries are resolved:
        failed exact carry, rebased neighbour seed, or the cold prior.
        Each slot draws from its request's own stream. The epochs run as
        the call returns (the early exit fetches a bool per epoch, counted
        in ``host_syncs``); the outputs stay on the device."""
        t0 = time.perf_counter()
        B = len(items)
        bclass = self._batch_class(B)

        hits_before = self.stats.compile_cache_hits
        fn = self._executable_batch(bucket, bclass)
        compile_hit = self.stats.compile_cache_hits > hits_before

        reqs = [it.req for it in items]
        carries = []
        for it in items:
            if it.carry is not None:
                carries.append(it.carry)
            elif it.seed is not None:
                carries.append(it.seed)
            else:
                carries.append(self._cold_carry(it.req))

        pad = bclass - B
        padded = list(reqs)
        if pad:
            pad_req, pad_carry = self._pad_slot(bucket, reqs[0], carries[0])
            padded += [pad_req] * pad
            carries = carries + [pad_carry] * pad
            if pad_req is not reqs[0] and self.cfg.early_exit \
                    and self.cfg.carry_fastpath:
                self.stats.pad_slots_frozen += pad
        Qb, Gb, maskb = self._upload_problems(padded)
        carry0 = self._stack_carries(carries)

        outs = fn([r.key for r in padded], Qb, Gb, maskb, carry0)
        self.stats.host_syncs += outs["host_syncs"]
        self.stats.batch_launches += 1
        self.stats.batch_problems += B
        self.stats.batch_slots += bclass
        self.stats.tier2.launches += 1
        self.stats.epoch_fused_launches += 1
        self.stats.epoch_finish_launches += 1
        self.stats.epoch_finish_problems += B
        self.stats.tier2.checked += B
        return _LaunchRecord(kind="swarm", bucket=bucket, items=items,
                             tier=2, B=B, bclass=bclass,
                             compile_hit=compile_hit, outs=outs,
                             padded=padded, t0=t0)

    def _apply_swarm(self, rec: _LaunchRecord, host: dict) -> None:
        """Consume one fetched swarm launch: build per-item results from
        the host outputs, store the still-on-device controller state for
        future warm starts."""
        items, B, padded = rec.items, rec.B, rec.padded
        host = dict(host, host_syncs=rec.outs["host_syncs"])
        batch_results = collect_batch_results(
            host, rec.bclass,
            orders=[r.order for r in padded],
            crops=[r.crop for r in padded])
        done = time.perf_counter()

        self.stats.tier2.wall_s += done - rec.t0
        for j, it in enumerate(items):
            base = batch_results[j]
            res = ServiceMatchResult(
                **{f.name: getattr(base, f.name)
                   for f in dataclasses.fields(MatchResult)})
            dev_carry = (rec.outs["S_star"][j], rec.outs["f_star"][j],
                         rec.outs["S_bar"][j])
            self._store_result_carries(it.req, it.warm_key, res, dev_carry)
            self.stats.epochs_run += res.epochs_run
            self._note_prune(1, res.prune_sweeps)
            if res.found:
                self.stats.found += 1
                self.stats.tier2.hits += 1
            if res.carry_verified:
                self.stats.carry_fastpath_hits += 1
            res.bucket = rec.bucket
            res.compile_cache_hit = rec.compile_hit
            res.warm_hit = it.warm_hit
            res.batch_size = B
            res.coalesced = B > 1
            res.tier = 2
            # end-to-end drain latency: a Tier-2 request also waited out
            # every pipeline launch that preceded this one
            it.latency_s = done - it.t0
            it.result = res

    def _launch_batch_legacy(self, bucket, reqs: List[_PendingRequest],
                             tickets: List[int], results: List) -> None:
        """The untiered drain path: every request goes straight to one
        uniform swarm launch (the ``tiered=False`` baseline)."""
        items = self._intake(reqs, tickets)
        self._launch_swarm(bucket, items)
        for it in items:
            it.result.latency_s = it.latency_s
            results[it.ticket] = it.result

    # -- reporting ---------------------------------------------------------

    def stats_dict(self) -> Dict[str, float]:
        """Flat ``{counter: value}`` export of :class:`ServiceStats` plus
        derived rates and per-tier breakdowns: the reference's key set.
        """
        s = self.stats
        out = {
            "calls": s.calls,
            "compile_cache_hits": s.compile_cache_hits,
            "compile_cache_misses": s.compile_cache_misses,
            "compile_hit_rate": s.compile_hit_rate,
            "warm_hits": s.warm_hits,
            "warm_misses": s.warm_misses,
            "warm_hit_rate": s.warm_hit_rate,
            "epochs_run": s.epochs_run,
            "epochs_budgeted": s.epochs_budgeted,
            "epochs_saved": s.epochs_saved,
            "epoch_fused_launches": s.epoch_fused_launches,
            "epoch_finish_launches": s.epoch_finish_launches,
            "epoch_finish_problems": s.epoch_finish_problems,
            "epoch_backend": kernel_backend.resolve_backend_name(
                self.cfg.backend),
            "found": s.found,
            "batch_launches": s.batch_launches,
            "coalesced_requests": s.coalesced_requests,
            "batch_problems": s.batch_problems,
            "batch_slots": s.batch_slots,
            "batch_occupancy": s.batch_occupancy,
            "carry_fastpath_hits": s.carry_fastpath_hits,
            "revalidated_rate": s.revalidated_rate,
            "pad_slots_frozen": s.pad_slots_frozen,
            "prune_problems": s.prune_problems,
            "prune_sweeps": s.prune_sweeps,
            "avg_prune_sweeps": s.avg_prune_sweeps,
            "sim_lookups": s.sim_lookups,
            "sim_neighbor_hits": s.sim_neighbor_hits,
            "sim_evictions": s.sim_evictions,
            "sim_entries": self._carries.sim_entries,
            "jit_traces": s.jit_traces,
            "aot_cache_hits": s.aot_cache_hits,
            "aot_cache_misses": s.aot_cache_misses,
            "aot_exports": s.aot_exports,
            "aot_export_failures": s.aot_export_failures,
            "aot_call_fallbacks": s.aot_call_fallbacks,
            "snapshot_saves": s.snapshot_saves,
            "snapshot_restores": s.snapshot_restores,
            "snapshot_stale_skipped": s.snapshot_stale_skipped,
            "snapshot_skipped_keys": s.snapshot_skipped_keys,
            "restored_carries": s.restored_carries,
            "restored_sim_entries": s.restored_sim_entries,
            "fe_submitted": s.fe_submitted,
            "fe_admitted": s.fe_admitted,
            "fe_shed": s.fe_shed,
            "fe_forced_drains": s.fe_forced_drains,
            "fe_drains": s.fe_drains,
            "fe_drain_deadline": s.fe_drain_deadline,
            "fe_drain_batch_full": s.fe_drain_batch_full,
            "fe_drain_flush": s.fe_drain_flush,
            "fe_queue_peak": s.fe_queue_peak,
            "fe_wait_s": s.fe_wait_s,
            "drains": s.drains,
            "host_syncs": s.host_syncs,
            "host_syncs_per_drain": s.host_syncs_per_drain,
            "host_bytes_transferred": s.host_bytes_transferred,
            "host_sync_wall_s": s.host_sync_wall_s,
            "donated_launches": s.donated_launches,
            "pool_puts": self._pool.puts,
            "pool_gathers": self._pool.gathers,
            "pool_live_rows": self._pool.live_rows,
        }
        for name in ("tier0", "tier1", "tier2"):
            t: TierStats = getattr(s, name)
            out[f"{name}_launches"] = t.launches
            out[f"{name}_checked"] = t.checked
            out[f"{name}_hits"] = t.hits
            out[f"{name}_hit_rate"] = t.hit_rate
            out[f"{name}_wall_s"] = t.wall_s
        return out


@dataclasses.dataclass
class _QueuedRequest:
    rid: int
    query: Graph
    target: Graph
    deadline: float
    enqueued_at: float
    key: object = None
    workload_key: object = None
    engine_sig: Optional[bytes] = None


class AsyncServiceFrontEnd:
    """Admission-controlled arrival queue in front of a MatcherService.

    Requests enter a bounded queue (``max_depth``); when it is full the
    ``policy`` either **sheds** the new request (recorded, result
    ``None``) or **blocks** it by forcing a drain round to make room
    first. A queued batch is drained through the service's tiered
    pipeline when either

      * the queue can fill the service's largest batch class
        (``batch_classes[-1]`` requests queued) — launch-shaped, or
      * the *oldest* queued request's slack ``deadline - now`` falls to
        ``slack_threshold_s`` — deadline-shaped (checked at submit time
        and by ``poll``), or
      * the caller explicitly ``flush``\\ es.

    Every trigger reason, shed, forced drain, queue peak, and cumulative
    queue wait flows into the service's ``ServiceStats`` (``fe_*`` keys
    of ``stats_dict()``).

    Time is an explicit ``now`` parameter everywhere (falling back to
    ``clock()``), so the front end runs on virtual time as readily as on
    a wall clock.
    """

    def __init__(self, service: MatcherService, *, max_depth: int = 64,
                 policy: str = "shed", slack_threshold_s: float = 0.0,
                 clock=time.perf_counter):
        if policy not in ("shed", "block"):
            raise ValueError(f"policy {policy!r}")
        if max_depth < 1:
            raise ValueError(f"max_depth {max_depth}")
        self.service = service
        self.max_depth = int(max_depth)
        self.policy = policy
        self.slack_threshold_s = float(slack_threshold_s)
        self._clock = clock
        self._queue: List[_QueuedRequest] = []
        self._results: Dict[int, Optional[ServiceMatchResult]] = {}
        self._next_rid = 0

    @property
    def depth(self) -> int:
        """Requests currently queued (admitted, not yet drained)."""
        return len(self._queue)

    def next_deadline_check(self) -> float:
        """Earliest instant the deadline trigger could fire (the oldest
        queued deadline minus the slack threshold); +inf when idle."""
        if not self._queue:
            return float("inf")
        return min(q.deadline for q in self._queue) - self.slack_threshold_s

    def submit(self, query: Graph, target: Graph, *,
               deadline: float = float("inf"),
               now: Optional[float] = None, key=None, workload_key=None,
               engine_sig: Optional[bytes] = None) -> int:
        """Offer a request; returns a request id for ``take_result``. A
        shed request (queue full under the shed policy) still gets an id;
        its result is recorded as ``None`` immediately."""
        now = self._clock() if now is None else now
        stats = self.service.stats
        rid = self._next_rid
        self._next_rid += 1
        stats.fe_submitted += 1
        if len(self._queue) >= self.max_depth:
            if self.policy == "shed":
                stats.fe_shed += 1
                self._results[rid] = None
                return rid
            stats.fe_forced_drains += 1
            self._drain(now, "batch_full")
        self._queue.append(_QueuedRequest(
            rid=rid, query=query, target=target, deadline=float(deadline),
            enqueued_at=now, key=key, workload_key=workload_key,
            engine_sig=engine_sig))
        stats.fe_admitted += 1
        stats.fe_queue_peak = max(stats.fe_queue_peak, len(self._queue))
        self._check_triggers(now)
        return rid

    def poll(self, now: Optional[float] = None) -> int:
        """Fire any due drain trigger; returns requests drained (0 if
        none due)."""
        now = self._clock() if now is None else now
        return self._check_triggers(now)

    def flush(self, now: Optional[float] = None) -> int:
        """Drain everything queued regardless of triggers."""
        now = self._clock() if now is None else now
        return self._drain(now, "flush")

    def take_result(self, rid: int) -> Optional[ServiceMatchResult]:
        """Pop the result for ``rid``: a ``ServiceMatchResult``, or
        ``None`` if the request was shed. Raises ``KeyError`` while the
        request is still queued."""
        return self._results.pop(rid)

    def _check_triggers(self, now: float) -> int:
        if not self._queue:
            return 0
        if len(self._queue) >= self.service.batch_classes[-1]:
            return self._drain(now, "batch_full")
        oldest_slack = min(q.deadline for q in self._queue) - now
        if oldest_slack <= self.slack_threshold_s:
            return self._drain(now, "deadline")
        return 0

    def _drain(self, now: float, reason: str) -> int:
        if not self._queue:
            return 0
        stats = self.service.stats
        stats.fe_drains += 1
        setattr(stats, f"fe_drain_{reason}",
                getattr(stats, f"fe_drain_{reason}") + 1)
        batch, self._queue = self._queue, []
        tickets = [self.service.submit(q.query, q.target, key=q.key,
                                       workload_key=q.workload_key,
                                       engine_sig=q.engine_sig)
                   for q in batch]
        results = self.service.drain()
        for q, ticket in zip(batch, tickets):
            self._results[q.rid] = results[ticket]
            stats.fe_wait_s += max(now - q.enqueued_at, 0.0)
        return len(batch)
