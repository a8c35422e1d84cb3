"""Schedulers: IMMSched + the five baselines of the paper's evaluation.

Every scheduler implements ``on_event(sim, now, tasks, trigger, arrived)``
and returns a decision dict::

    {"alloc":   {task_id: [engine ids]},
     "preempt": [task_id, ...],
     "delay":   {task_id: seconds},       # scheduling latency seen by task
     "energy":  joules}                   # scheduling energy

Protocol: ``arrival``/``completion`` triggers may charge scheduling cost
(latency via "delay" + energy); ``activate`` triggers are cost-free
dispatch of tasks whose scheduling delay has elapsed. Engines freed for a
delayed urgent task are *reserved* until it activates so preempted victims
cannot bounce back onto them.

``arrived`` is the LIST of all tasks that became schedulable at this
instant (the simulator coalesces simultaneous/burst arrivals into one
event). IMMSched makes one batched matching decision for the burst and
charges its latency once. IsoSched's serial host matcher processes the
burst one problem at a time, queueing on the single CPU. LTS baselines
re-solve their global layout/priority state once per event — one
re-solve covers the burst, the conservative (cheapest-for-baseline)
reading of how those frameworks respond to a scheduling trigger.

Paradigms:
  * IMMSched      — TSS, interruptible: subgraph matching ON the accelerator
                    (parallel PSO-Ullmann; μs-scale), adaptive preemption
                    ratio + largest-slack victim selection.
  * IsoSched-like — TSS, preemptive: *serial* Ullmann matching on the host
                    CPU (ms-scale, grows with query size).
  * PREMA-like    — LTS, exclusive array, token-priority time-multiplexing.
  * Planaria-like — LTS, spatial fission, heavy online layout search.
  * MoCA-like     — LTS, fission + memory-contention awareness.
  * CD-MSA-like   — LTS, EDF cooperative with cross-layer overlap.

Port of the JAX package's ``sched/schedulers.py``: the same policies and
cost charges in the same order (numpy and Python floats), with IMMSched's
real-mode decisions going through the port's ``MatcherService`` on
``SimConfig.device``. A restart is warm under ``SimConfig.persist_dir``
(IMMSched snapshots its service and tier predictor before the kill and
restores them after), cold otherwise.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core import interrupts, preemptible_dag, ullmann
from repro_torch.core.graphs import compatibility_mask
from repro_torch.core.service import MatcherService
from repro_torch.accel.target_graph import (free_engine_graph,
                                      free_engine_signature,
                                      signature_bits)

_EPS = 1e-15


def _empty_decision():
    return {"alloc": {}, "preempt": [], "delay": {}, "energy": 0.0}


class SchedulerBase:
    name = "base"
    paradigm = "tss"
    overlap = 0.0

    def reset(self, sim):
        self.cpu_free_at = 0.0
        self._pdag_cache: Dict = {}
        self._reserved: Dict[int, List[int]] = {}   # task_id -> engines
        self._restart_count = 0

    def matcher_stats(self) -> Dict[str, float]:
        """Online matcher-service counters; {} for schedulers without one."""
        return {}

    def check_invariants(self, result) -> None:
        """End-of-run cross-checks, called by the simulator on the
        finished :class:`SimResult` when ``SimConfig.validate`` is set.

        Base check: no registered scheduler ever double-books an engine
        (``alloc_conflicts == 0``) — the simulator counts conflicts
        rather than crashing so hostile test schedulers can probe the
        counter, but every real policy must stay clean. Subclasses add
        their own accounting invariants on top (IMMSched: per-tier
        decision counts sum to matcher decisions). Raises
        ``AssertionError`` on violation."""
        assert result.alloc_conflicts == 0, \
            f"{self.name}: {result.alloc_conflicts} engine " \
            "double-bookings in a conflict-free scheduler"

    def on_restart(self, sim, now: float) -> None:
        """Scheduler-process kill/restart at ``now`` (simulator event).

        Base semantics: everything living in the scheduler's host
        process dies — the query-window cache, engine reservations (the
        accelerator keeps running its dispatched tasks; only the
        scheduler's bookkeeping of promised engines is lost) and any
        queued host-CPU scheduling work (a fresh process has a free
        CPU). Subclasses lose their matcher/memo state on top, and
        IMMSched snapshots/restores through the persistence layer when
        ``sim.cfg.persist_dir`` is set."""
        self._restart_count += 1
        self._pdag_cache.clear()
        self._reserved.clear()
        self.cpu_free_at = now

    # -- engine bookkeeping ------------------------------------------------

    def _free_engines(self, sim, tasks) -> List[int]:
        used: Set[int] = set()
        for t in tasks:
            if t.status == "running":
                used.update(t.engines)
        # drop stale reservations, keep live ones out of the free pool
        # (a reserved task may have finished and left the live table)
        for tid in list(self._reserved):
            try:
                alive = tasks[tid].status == "ready"
            except (KeyError, IndexError):
                alive = False
            if not alive:
                del self._reserved[tid]
        for engines in self._reserved.values():
            used.update(engines)
        return [e for e in range(sim.platform.engines) if e not in used]

    def _waiting(self, tasks):
        return sorted([t for t in tasks if t.status == "ready"],
                      key=lambda t: (-t.spec.priority, t.spec.arrival))

    def _dispatch(self, sim, now, tasks, decision=None):
        """Cost-free work-conserving dispatch of ready, delay-elapsed tasks:
        reserved engines first, then the free pool."""
        decision = decision or _empty_decision()
        free = self._free_engines(sim, tasks)
        for v in decision["alloc"].values():
            free = [e for e in free if e not in set(v)]
        for t in self._waiting(tasks):
            if t.spec.task_id in decision["alloc"]:
                continue
            if now < t.ready_at - _EPS or \
                    t.spec.task_id in decision["delay"]:
                continue
            engines = self._reserved.pop(t.spec.task_id, [])
            engines = [e for e in engines
                       if e in free or e not in self._all_running(tasks)]
            if not engines:
                if not free:
                    continue
                engines = free[:min(t.par_cap, len(free))]
            engines = engines[:t.par_cap]
            free = [e for e in free if e not in set(engines)]
            if engines:
                decision["alloc"][t.spec.task_id] = engines
        return decision

    @staticmethod
    def _all_running(tasks) -> Set[int]:
        out: Set[int] = set()
        for t in tasks:
            if t.status == "running":
                out.update(t.engines)
        return out

    # -- query-window construction ------------------------------------------

    def _pdag(self, sim, task):
        key = (task.spec.name, sim.cfg.window_stages)
        if key not in self._pdag_cache:
            cap = sim.platform.engine_tile_capacity_macs()
            self._pdag_cache[key] = preemptible_dag.build_preemptible_dag(
                [(task.spec.task_id, task.spec.workload, 0)],
                tile_capacity_macs=cap,
                window_stages=sim.cfg.window_stages)
        return self._pdag_cache[key]

    def _window_tiles(self, sim, task) -> int:
        return max(self._pdag(sim, task).n, 1)


# ---------------------------------------------------------------------------
# TSS schedulers
# ---------------------------------------------------------------------------

class IMMSchedScheduler(SchedulerBase):
    """TSS, interruptible, with the *tiered* matcher pipeline's latency
    accounting: every matching decision is first a cheap revalidation
    (Tier 0/1 — one projection on the accelerator), and only predicted
    warm misses (the hard subset of a burst) pay for a swarm launch.
    The predictor mirrors the service's carry store: a (workload,
    free-engine signature) pair seen before is a Tier-0 hit; the same
    workload on a sufficiently-overlapping engine set is a Tier-1 rebase;
    anything else swarms (Tier 2)."""
    name = "immsched"
    paradigm = "tss"

    _SIG_MEMORY = 64                 # platform states remembered per task
    _REBASE_OVERLAP = 0.5            # min engine-set overlap for a Tier-1
                                     # rebase prediction
    _T1_PRIOR = (2, 3)               # pseudo-counts behind the analytic
                                     # ≥50%-overlap heuristic (2/3 prior
                                     # success); real-mode outcomes shift
                                     # the posterior per (workload,
                                     # engine-signature) bucket
    _T1_PC_BUCKET = 8                # popcount band width of the bucket
    _PRUNE_SWEEPS = 4                # assumed fused pre-prune iterations
                                     # until real launches calibrate it

    def __init__(self, quantized: bool = True):
        self.quantized = quantized
        self._service: Optional[MatcherService] = None

    def reset(self, sim):
        super().reset(sim)
        self._tier_decisions = {"tier0": 0, "tier1": 0, "tier2": 0}
        # every task routed through the tier predictor (normal bursts +
        # urgent interrupts); check_invariants pins the per-tier split
        # to this total
        self._matcher_decisions = 0
        self._restart_stats = {"restored_carries": 0,
                               "restored_sim_entries": 0,
                               "restored_posterior_buckets": 0,
                               "restored_state_sigs": 0,
                               "snapshots_saved": 0,
                               "boot_restores": 0}
        self._boot_service(sim)

    def _boot_service(self, sim, from_restart: bool = False) -> None:
        """(Re)create the host-process matcher state: the online service
        on ``sim.cfg.device``, the tier predictor's platform-state index
        and the calibrated Tier-1 posterior. With ``sim.cfg.persist_dir``
        the newest valid snapshot (carries and predictor posteriors) is
        restored, a warm boot; otherwise every structure starts cold
        (``persist_dir=False`` keeps the service off
        ``REPRO_PERSIST_DIR``). Restores count in the
        ``restart_restored_*`` counters only when this boot follows an
        in-run restart event; a warm boot at the start of a simulation (a
        previous run's snapshot) counts in ``boot_restores``."""
        # online matcher service: callable cache + warm starts keyed by
        # (workload, free-engine set), early-exit epochs, tiered drain
        cfg = sim.cfg.pso_cfg.replace(quantized=self.quantized)
        persist_dir = sim.cfg.persist_dir
        self._service = MatcherService(cfg, device=sim.cfg.device,
                                       persist_dir=persist_dir or False)
        # per workload: LRU of seen platform states, sig → unpacked bits
        self._state_index: Dict[str, "OrderedDict[bytes, np.ndarray]"] = {}
        # observed Tier-1 rebase outcomes per (workload, popcount band of
        # the engine signature): [successes, trials]
        self._tier1_obs: Dict[tuple, List[int]] = {}
        self._prune_stats = {"launches": 0, "wall_s": 0.0, "energy_j": 0.0}
        if persist_dir:
            extra = self._service.restore_snapshot()
            if extra is not None:
                self._restore_predictor(extra.get("predictor", {}),
                                        count=from_restart)
                if from_restart:
                    self._restart_stats["restored_carries"] += \
                        self._service.stats.restored_carries
                    self._restart_stats["restored_sim_entries"] += \
                        self._service.stats.restored_sim_entries
                else:
                    self._restart_stats["boot_restores"] += 1

    def on_restart(self, sim, now):
        """Kill/restart of the scheduler process (simulator event).

        Warm when persistence is on: the service snapshots its carries
        with the tier predictor's posteriors in the snapshot's ``extra``
        dict, then every host structure is dropped (process death) and
        ``_boot_service`` restores them from disk. Without
        ``persist_dir`` it is a cold restart: carries, the callable LRU,
        predictor history and calibration all start over."""
        if sim.cfg.persist_dir and self._service is not None:
            self._service.save_snapshot(
                extra={"predictor": self._predictor_state()})
            self._restart_stats["snapshots_saved"] += 1
        super().on_restart(sim, now)
        self._boot_service(sim, from_restart=True)

    # -- predictor snapshot codecs ---------------------------------------

    def _predictor_state(self) -> Dict:
        """JSON-safe encoding of the tier predictor: the per-workload
        platform-state LRU (signatures only; the bit vectors are derived
        again on load) and the calibrated Tier-1 posterior counts."""
        return {
            "state_index": [[name, [sig.hex() for sig in sigs]]
                            for name, sigs in self._state_index.items()],
            "tier1_obs": [[name, band, h, t]
                          for (name, band), (h, t)
                          in self._tier1_obs.items()],
        }

    def _restore_predictor(self, d: Dict, count: bool = True) -> None:
        """Inverse of ``_predictor_state`` (missing keys are tolerated, so
        a snapshot written by a service without a scheduler restores as a
        plain carry restore). ``count=False`` restores without touching
        the ``restart_restored_*`` counters (warm boots)."""
        for name, sigs in d.get("state_index", []):
            for hex_sig in sigs:
                self._note_state(name, bytes.fromhex(hex_sig))
                if count:
                    self._restart_stats["restored_state_sigs"] += 1
        for name, band, h, t in d.get("tier1_obs", []):
            self._tier1_obs[(name, int(band))] = [int(h), int(t)]
            if count:
                self._restart_stats["restored_posterior_buckets"] += 1

    def matcher_stats(self) -> Dict[str, float]:
        d = self._service.stats_dict() if self._service else {}
        for k, v in getattr(self, "_tier_decisions", {}).items():
            d[f"sched_{k}_decisions"] = v
        d["sched_matcher_decisions"] = getattr(
            self, "_matcher_decisions", 0)
        obs = getattr(self, "_tier1_obs", {})
        d["sched_tier1_calib_hits"] = sum(v[0] for v in obs.values())
        d["sched_tier1_calib_trials"] = sum(v[1] for v in obs.values())
        for k, v in getattr(self, "_prune_stats", {}).items():
            d[f"sched_prune_{k}"] = v
        d["restart_count"] = getattr(self, "_restart_count", 0)
        for k, v in getattr(self, "_restart_stats", {}).items():
            d[f"restart_{k}"] = v
        return d

    def check_invariants(self, result) -> None:
        """Tier-accounting cross-checks on top of the base conflict
        check: every task routed through the tier predictor landed in
        exactly one tier (``sched_tier{0,1,2}_decisions`` sum to
        ``sched_matcher_decisions``) and the Tier-1 calibration never
        records more successes than trials. Runs on every
        ``SimConfig.validate`` simulation, analytic or real."""
        super().check_invariants(result)
        ms = result.matcher_stats
        tiers = sum(ms.get(f"sched_tier{i}_decisions", 0)
                    for i in range(3))
        charged = ms.get("sched_matcher_decisions", 0)
        assert tiers == charged, \
            f"per-tier decisions ({tiers}) != tasks routed through " \
            f"the tier predictor ({charged})"
        assert ms.get("sched_tier1_calib_hits", 0) <= \
            ms.get("sched_tier1_calib_trials", 0), "calibration hits " \
            "exceed trials"

    # -- warm-state predictor (mirrors the service carry store) ----------

    def _free_sig(self, sim, tasks) -> bytes:
        free = set(self._free_engines(sim, tasks))
        return free_engine_signature(
            [e in free for e in range(sim.platform.engines)])

    def _tier1_bucket(self, name: str, sig: bytes) -> tuple:
        """Calibration bucket: workload × popcount band of the free-engine
        signature (platform states with similar free-set sizes fail or
        succeed rebases together under fragmentation churn)."""
        pc = int(signature_bits(sig).sum())
        return (name, pc // self._T1_PC_BUCKET)

    def _tier1_success_prob(self, name: str, sig: bytes) -> float:
        """Posterior Tier-1 rebase success probability for this bucket:
        observed real-mode outcomes blended with the pseudo-count prior
        the analytic ≥50%-overlap heuristic implies. With no observations
        this is the prior (> 0.5), so analytic-only runs predict exactly
        as before calibration existed."""
        h, t = self._tier1_obs.get(self._tier1_bucket(name, sig), (0, 0))
        ph, pt = self._T1_PRIOR
        return (h + ph) / (t + pt)

    def _note_tier1_outcome(self, name: str, sig: bytes, ok: bool) -> None:
        """Record a real-mode rebase outcome for a predicted-Tier-1
        decision (served at tier ≤ 1 = the rebase verified)."""
        key = self._tier1_bucket(name, sig)
        h, t = self._tier1_obs.get(key, (0, 0))
        self._tier1_obs[key] = [h + (1 if ok else 0), t + 1]

    def _calibrate_tier1(self, preds, raws) -> None:
        """Update the rebase posterior from a real-mode launch.

        Predicted-Tier-1 decisions record their outcome directly. A
        predicted-Tier-2 decision that the pipeline actually served by a
        *verified rebase* (``raw.tier == 1``) records a success too —
        without it a bucket whose posterior once dropped below 0.5 would
        be predicted Tier-2 forever (outcomes only flow from Tier-1
        predictions) even while the real pipeline keeps rebasing it
        fine. Tier-0 serves and cold misses are neutral: neither says
        anything about rebase success."""
        for (name, sig, ptier), raw in zip(preds, raws):
            if raw is None:
                continue
            if ptier == 1:
                self._note_tier1_outcome(name, sig,
                                         raw.found and raw.tier <= 1)
            elif ptier == 2 and raw.found and raw.tier == 1:
                self._note_tier1_outcome(name, sig, True)

    def _predict_tier(self, name: str, sig: bytes) -> int:
        sigs = self._state_index.get(name)
        if not sigs:
            return 2
        if sig in sigs:
            return 0
        bits = signature_bits(sig)
        denom = max(int(bits.sum()), 1)
        for b in sigs.values():         # bits decoded once, at note time
            if b.shape == bits.shape \
                    and int((b & bits).sum()) / denom >= self._REBASE_OVERLAP:
                # overlap alone over-promises under churn: gate the Tier-1
                # prediction on the calibrated success posterior so a
                # bucket whose rebases keep failing re-verification is
                # charged (and predicted) as a swarm decision again
                if self._tier1_success_prob(name, sig) >= 0.5:
                    return 1
                return 2
        return 2

    def _note_state(self, name: str, sig: bytes) -> None:
        d = self._state_index.setdefault(name, OrderedDict())
        d[sig] = signature_bits(sig)
        d.move_to_end(sig)
        while len(d) > self._SIG_MEMORY:
            d.popitem(last=False)

    def _prune_cost(self, sim, n: int, m: int, engines: int):
        """Latency/energy of the fused pre-prune a Tier-2 (cold/swarm)
        decision pays before its first epoch. The assumed sweep count is
        calibrated online against the real launches' ``prune_sweeps``
        observable once any are available; charges accumulate in
        ``sched_prune_*`` stats."""
        sweeps = self._PRUNE_SWEEPS
        if self._service is not None \
                and self._service.stats.prune_problems > 0:
            sweeps = max(1, round(self._service.stats.avg_prune_sweeps))
        st, se = sim.cost.sched_immsched_prune(n, m, engines, sweeps=sweeps)
        self._prune_stats["launches"] += 1
        self._prune_stats["wall_s"] += st
        self._prune_stats["energy_j"] += se
        return st, se

    def _charge_tiers(self, sim, normal, sig, decision) -> None:
        """Per-tier latency for a burst: one revalidation launch covers
        the warm tasks (Tier 0/1); a swarm launch sized to the
        predicted-miss (hard) subset — plus the fused mask pre-prune that
        precedes any swarm — is charged only to those tasks; an easy task
        in a mixed burst no longer waits out the hard neighbours' swarm.
        A fully cold burst issues NO revalidation launch (the real
        pipeline skips Tier 0/1 when nothing is stored), so it is charged
        prune + swarm alone."""
        m = sim.platform.engines
        self._matcher_decisions += len(normal)
        tiers = {t.spec.task_id: self._predict_tier(t.spec.name, sig)
                 for t in normal}
        warm = [t for t in normal if tiers[t.spec.task_id] < 2]
        hard = [t for t in normal if tiers[t.spec.task_id] == 2]
        st_r = se_r = 0.0
        if warm:
            n_warm = max(self._window_tiles(sim, t) for t in warm)
            st_r, se_r = sim.cost.sched_immsched_revalidate(
                min(n_warm, 64), m, max(min(n_warm, m) // 2, 1),
                batch=len(warm))
        st_s = se_s = 0.0
        if hard:
            n_hard = max(self._window_tiles(sim, t) for t in hard)
            eng = max(min(n_hard, m) // 2, 1)
            st_p, se_p = self._prune_cost(sim, min(n_hard, 64), m, eng)
            st_s, se_s = sim.cost.sched_immsched(
                min(n_hard, 64), m, sim.cfg.pso_cfg, eng)
            st_s += st_p
            se_s += se_p
        for t in normal:
            tier = tiers[t.spec.task_id]
            self._tier_decisions[f"tier{tier}"] += 1
            # Tier-2 tasks queue behind the revalidation launch (if one
            # ran) before their swarm completes
            decision["delay"][t.spec.task_id] = (st_r if tier < 2
                                                 else st_r + st_s)
            self._note_state(t.spec.name, sig)
        decision["energy"] += se_r + se_s

    def on_event(self, sim, now, tasks, trigger, arrived=None):
        if trigger == "activate":
            return self._dispatch(sim, now, tasks)
        decision = _empty_decision()
        if trigger == "arrival" and arrived:
            urgent = [t for t in arrived if t.spec.urgent]
            normal = [t for t in arrived if not t.spec.urgent]
            if urgent:
                self._interrupt(sim, now, tasks, urgent, decision)
            if normal:
                self._charge_tiers(sim, normal,
                                   self._free_sig(sim, tasks), decision)
        elif trigger == "completion":
            waiting = self._waiting(tasks)
            if waiting:
                self._charge_tiers(sim, waiting[:1],
                                   self._free_sig(sim, tasks), decision)
        return self._dispatch(sim, now, tasks, decision)

    def _interrupt(self, sim, now, tasks, urgent_list, decision):
        """Free engines for a burst of urgent tasks: victim selection runs
        per task against the shrinking pool, but the subgraph matchings of
        the whole burst go out as ONE batched service decision, and the
        burst pays one (the largest) scheduling latency — not K of them."""
        running = [
            interrupts.RunningTask(
                task_id=t.spec.task_id, priority=t.spec.priority,
                engines=list(t.engines),
                remaining_time=t.remaining_time(len(t.engines)),
                deadline=t.spec.deadline, live_bytes=t.live_bytes)
            for t in tasks if t.status == "running"]
        free = self._free_engines(sim, tasks)
        self._matcher_decisions += len(urgent_list)
        preempted: set = set()
        grants = []          # (urgent, engines, freed_engines, need)
        preds = []           # (name, sig, predicted tier) per grant
        st_batch = se_batch = 0.0
        for urgent in urgent_list:
            live = [r for r in running if r.task_id not in preempted]
            n = self._window_tiles(sim, urgent)
            est_exec = urgent.remaining_time(min(n, sim.platform.engines))
            ratio = interrupts.adaptive_preemption_ratio(
                est_exec, urgent.spec.deadline - now)
            need = interrupts.engines_needed_for(n, sim.platform.engines,
                                                 ratio)
            dec = interrupts.select_victims(live, free, need,
                                            urgent.spec.priority, now)
            engines = dec.freed_engines[:need]
            m = max(len(dec.freed_engines), 1)
            # tiered accounting: a (workload, freed-engine-set) pair the
            # pipeline has warm state for re-validates instead of swarming
            freed_set = set(dec.freed_engines)
            sig = free_engine_signature(
                [e in freed_set for e in range(sim.platform.engines)])
            tier = self._predict_tier(urgent.spec.name, sig)
            self._tier_decisions[f"tier{tier}"] += 1
            self._note_state(urgent.spec.name, sig)
            preds.append((urgent.spec.name, sig, tier))
            if tier < 2:
                st, se = sim.cost.sched_immsched_revalidate(
                    min(n, 64), m, max(len(engines), 1))
            else:
                st_p, se_p = self._prune_cost(sim, min(n, 64), m,
                                              max(len(engines), 1))
                st, se = sim.cost.sched_immsched(
                    min(n, 64), m, sim.cfg.pso_cfg, max(len(engines), 1))
                st += st_p
                se += se_p
            # one batched launch: latency = slowest problem in the batch,
            # energy = one swarm (the problems share it), not K swarms
            st_batch = max(st_batch, st)
            se_batch = max(se_batch, se)
            preempted.update(dec.victims)
            decision["preempt"].extend(dec.victims)
            # engines this task did not take stay idle for the next one
            free = [e for e in dec.freed_engines if e not in set(engines)]
            grants.append((urgent, engines, dec.freed_engines, need))
        if sim.cfg.matcher_mode == "real":
            mapped, raws = self._real_match_batch(
                sim, [(u, freed) for u, _, freed, _ in grants])
            for i, (urgent, engines, freed, need) in enumerate(grants):
                if mapped[i]:
                    grants[i] = (urgent, mapped[i][:max(need, 1)],
                                 freed, need)
            self._calibrate_tier1(preds, raws)
        # deconflict: a real-match maps over its task's FULL freed set, so
        # a later grant may land on engines an earlier task already took —
        # reservations must stay disjoint within the burst. A fully
        # claimed grant falls back to its own freed list, then to any
        # engine freed for the burst as a whole.
        all_freed = [e for _, _, freed, _ in grants for e in freed]
        claimed: Set[int] = set()
        for urgent, engines, freed, need in grants:
            engines = [e for e in engines if e not in claimed]
            if not engines:
                pool = ([e for e in freed if e not in claimed]
                        or [e for e in all_freed if e not in claimed])
                engines = pool[:max(need, 1)]
            claimed.update(engines)
            decision["delay"][urgent.spec.task_id] = st_batch
            self._reserved[urgent.spec.task_id] = engines
        decision["energy"] += se_batch

    def _real_match_batch(self, sim, pairs):
        """Run the burst's matchings as one coalesced service launch.
        ``pairs``: (urgent_task, freed_engine_list) per urgent arrival.
        Returns ``(engines, results)``: per-task engine lists (None where
        no match) and the raw per-task ``ServiceMatchResult`` (None where
        no problem was launched) for tier-outcome calibration."""
        problems, wkeys, sigs, targets, slots = [], [], [], [], []
        for urgent, freed in pairs:
            pd = self._pdag(sim, urgent)
            free = [e in set(freed) for e in range(sim.platform.engines)]
            tgt = free_engine_graph(sim.platform, free)
            if pd.n == 0 or tgt.n < 4:
                slots.append(None)
                continue
            q = pd.graph
            if q.n > tgt.n:
                keep = np.sort(np.argsort(
                    [t.stage for t in pd.tiles])[:tgt.n])
                q = type(q)(adj=q.adj[np.ix_(keep, keep)],
                            types=q.types[keep], weights=q.weights[keep])
            slots.append(len(problems))
            problems.append((q, tgt))
            targets.append(tgt)
            sig = free_engine_signature(free)
            wkeys.append((urgent.spec.name, sig))
            sigs.append(sig)
        results = (self._service.match_many(problems, workload_keys=wkeys,
                                            engine_sigs=sigs)
                   if problems else [])
        out: List[Optional[List[int]]] = []
        raws = []
        for slot in slots:
            raws.append(None if slot is None else results[slot])
            if slot is None or not results[slot].found:
                out.append(None)
                continue
            engine_ids = targets[slot].weights.astype(int)
            _, cols = np.where(results[slot].mapping)
            out.append([int(engine_ids[c]) for c in cols])
        return out, raws


class IsoSchedScheduler(SchedulerBase):
    """TSS + preemption, but scheduling = serial Ullmann on the host CPU.

    Warm traffic goes through a minimal host-side memo cache keyed like
    the matcher service — (workload, window config, platform state) — so
    a repeat decision re-verifies the cached mapping with one refinement
    sweep instead of re-running the backtracking search. This keeps the
    IsoSched baseline apples-to-apples with IMMSched's warm tiers in
    `benchmarks/`: both sides get to remember their last decision; the
    gap that remains is serial-CPU vs on-accelerator matching."""
    name = "isosched"
    paradigm = "tss"

    def reset(self, sim):
        super().reset(sim)
        self._memo: Set = set()
        self._memo_hits = 0
        self._memo_misses = 0

    def on_restart(self, sim, now):
        """IsoSched keeps all matcher state on the host CPU, so a process
        restart flushes the memo cache unconditionally — the serial
        baseline has no persistence story."""
        super().on_restart(sim, now)
        self._memo.clear()

    def matcher_stats(self) -> Dict[str, float]:
        return {"memo_hits": self._memo_hits,
                "memo_misses": self._memo_misses,
                "memo_entries": len(getattr(self, "_memo", {})),
                "restart_count": getattr(self, "_restart_count", 0)}

    def on_event(self, sim, now, tasks, trigger, arrived=None):
        if trigger == "activate":
            return self._dispatch(sim, now, tasks)
        decision = _empty_decision()
        # serial host matcher: a burst is processed ONE problem at a time,
        # each queueing behind the previous on the single CPU. Victim
        # selection tracks the burst's earlier picks (task statuses only
        # change when the decision is applied) so reservations stay
        # disjoint, as they were when each arrival was its own event.
        targets = []
        if trigger == "arrival" and arrived:
            targets = list(arrived)
            preempted: Set[int] = set()
            claimed: Set[int] = set()
            for a in arrived:
                if not a.spec.urgent:
                    continue
                running = [
                    interrupts.RunningTask(
                        task_id=t.spec.task_id, priority=t.spec.priority,
                        engines=list(t.engines),
                        remaining_time=t.remaining_time(len(t.engines)),
                        deadline=t.spec.deadline, live_bytes=t.live_bytes)
                    for t in tasks
                    if t.status == "running"
                    and t.spec.task_id not in preempted]
                free = [e for e in self._free_engines(sim, tasks)
                        if e not in claimed]
                n = self._window_tiles(sim, a)
                need = interrupts.engines_needed_for(
                    n, sim.platform.engines, 1.0)
                dec = interrupts.select_victims(
                    running, free, need, a.spec.priority, now)
                preempted.update(dec.victims)
                decision["preempt"].extend(dec.victims)
                engines = [e for e in dec.freed_engines
                           if e not in claimed][:need]
                claimed.update(engines)
                self._reserved[a.spec.task_id] = engines
        elif trigger == "completion":
            waiting = self._waiting(tasks)
            targets = waiting[:1]
        for target in targets:
            st, se = self._serial_match_cost(sim, target, now)
            decision["delay"][target.spec.task_id] = st
            decision["energy"] += se
        return self._dispatch(sim, now, tasks, decision)

    def _serial_match_cost(self, sim, task, now):
        n = self._window_tiles(sim, task)
        m = sim.platform.engines
        # host memo keyed like the service: (workload, window config,
        # platform state). IsoSched always matches onto the full array,
        # so the state component is the all-free signature.
        sig = free_engine_signature([True] * m)
        memo_key = (task.spec.name, sim.cfg.window_stages, m, sig)
        if memo_key in self._memo:
            # warm hit: re-verify the remembered mapping with ONE
            # refinement sweep — no backtracking search
            self._memo_hits += 1
            mac_ops, nodes = 2.0 * n * m * m + 2.0 * n * n * m, 1
            st, se = sim.cost.sched_serial_cpu(mac_ops, int(nodes))
            start = max(self.cpu_free_at, now)
            self.cpu_free_at = start + st
            return (start - now) + st, se
        self._memo_misses += 1
        if sim.cfg.matcher_mode == "real":
            pd = self._pdag(sim, task)
            tgt = free_engine_graph(sim.platform,
                                    [True] * sim.platform.engines)
            q = pd.graph
            if q.n > tgt.n:
                keep = np.sort(np.argsort(
                    [t.stage for t in pd.tiles])[:tgt.n])
                q = type(q)(adj=q.adj[np.ix_(keep, keep)],
                            types=q.types[keep], weights=q.weights[keep])
            stats = ullmann.SerialStats()
            mask = compatibility_mask(q, tgt)
            sols = ullmann.serial_ullmann(q.adj, tgt.adj, mask,
                                          max_solutions=1, stats=stats)
            mac_ops, nodes = stats.mac_ops, stats.nodes_visited
            if not sols:
                # nothing to remember: an unmatchable window has no
                # mapping to re-verify, so repeats pay the search again
                st, se = sim.cost.sched_serial_cpu(mac_ops, int(nodes))
                start = max(self.cpu_free_at, now)
                self.cpu_free_at = start + st
                return (start - now) + st, se
        else:
            # calibrated against serial_ullmann stats on planted windows
            nodes = 0.3 * n
            sweeps_per_node = 2.0
            mac_ops = nodes * sweeps_per_node * (
                2 * n * m * m + 2 * n * n * m)
        self._memo.add(memo_key)
        st, se = sim.cost.sched_serial_cpu(mac_ops, int(nodes))
        # single host CPU: queue behind earlier scheduling work
        start = max(self.cpu_free_at, now)
        self.cpu_free_at = start + st
        return (start - now) + st, se


# ---------------------------------------------------------------------------
# LTS baselines
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LTSVariant:
    name: str
    fission: bool            # spatial sharing (Planaria/MoCA/CD-MSA)
    overlap: float           # cross-layer overlap factor (CD-MSA)
    mem_contention: float    # serial-bucket penalty per co-runner
    sched_scale: float       # online scheduling latency multiplier


LTS_VARIANTS = {
    "prema": LTSVariant("prema", fission=False, overlap=0.0,
                        mem_contention=0.0, sched_scale=0.45),
    "planaria": LTSVariant("planaria", fission=True, overlap=0.0,
                           mem_contention=0.20, sched_scale=1.3),
    "moca": LTSVariant("moca", fission=True, overlap=0.0,
                       mem_contention=0.05, sched_scale=0.42),
    "cdmsa": LTSVariant("cdmsa", fission=True, overlap=0.3,
                        mem_contention=0.15, sched_scale=0.85),
}


class LTSScheduler(SchedulerBase):
    paradigm = "lts"

    def __init__(self, variant: str):
        self.variant = LTS_VARIANTS[variant]
        self.name = variant
        self.overlap = self.variant.overlap

    def _sched_cost(self, sim, tasks, now):
        """Online re-scheduling on the host CPU: LTS frameworks re-solve a
        layout/partition optimization per decision (paper Fig. 2a — often
        orders of magnitude longer than the execution itself)."""
        # only tasks the host can actually see (arrived, not finished):
        # reading pending/unarrived tasks would leak future information
        # into the cost model and break streaming runs, where unarrived
        # tasks simply don't exist yet
        n_layers = int(np.mean(
            [len(t.spec.workload.layers) for t in tasks
             if t.status in ("ready", "running")] or [32]))
        work_ops = 2.0e5 * n_layers * sim.platform.engines / 64.0
        t = (work_ops / (sim.platform.cpu_gops * 1e9)
             + 2e-3) * self.variant.sched_scale
        start = max(self.cpu_free_at, now)
        self.cpu_free_at = start + t
        return (start - now) + t, t * sim.cost.cpu_watts

    def on_event(self, sim, now, tasks, trigger, arrived=None):
        if trigger == "activate":
            return (self._dispatch(sim, now, tasks)
                    if not self.variant.fission
                    else self._fission_alloc(sim, now, tasks, None))
        decision = _empty_decision()
        waiting = self._waiting(tasks)
        if not waiting and trigger != "completion":
            return decision
        st, se = self._sched_cost(sim, tasks, now)
        decision["energy"] = se

        if not self.variant.fission:
            # PREMA: exclusive array, priority time-multiplexing
            if not waiting:
                return self._dispatch(sim, now, tasks, decision)
            best = waiting[0]
            running = [t for t in tasks if t.status == "running"]
            if running:
                cur = running[0]
                if best.spec.priority <= cur.spec.priority:
                    return decision
                decision["preempt"].append(cur.spec.task_id)
            decision["delay"][best.spec.task_id] = st
            self._reserved[best.spec.task_id] = list(
                range(sim.platform.engines))
            return decision

        # fission variants: recompute proportional spatial shares (one
        # layout re-solve covers the whole burst; each task still waits
        # out the scheduling latency before activation)
        for a in (arrived or []):
            decision["delay"][a.spec.task_id] = st
        return self._fission_alloc(sim, now, tasks, decision)

    def _fission_alloc(self, sim, now, tasks, decision):
        decision = decision or _empty_decision()
        active = [t for t in tasks if t.status in ("running", "ready")]
        if self.name == "cdmsa":
            active.sort(key=lambda t: t.spec.deadline)        # EDF
        else:
            active.sort(key=lambda t: (-t.spec.priority, t.spec.arrival))
        eligible = [t for t in active
                    if t.status == "running"
                    or (now >= t.ready_at - _EPS
                        and t.spec.task_id not in decision["delay"])]
        total_prio = sum(t.spec.priority for t in eligible) or 1
        E = sim.platform.engines
        cursor = 0
        n_active = len(eligible)
        for t in eligible:
            share = max(1, int(E * t.spec.priority / total_prio))
            share = min(share, t.par_cap, E - cursor)
            if share <= 0:
                break
            engines = list(range(cursor, cursor + share))
            cursor += share
            if t.status == "running":
                if set(engines) == set(t.engines):
                    continue
                decision["preempt"].append(t.spec.task_id)
            decision["alloc"][t.spec.task_id] = engines
            # memory contention under sharing
            pen = self.variant.mem_contention * max(n_active - 1, 0)
            if pen > 0:
                t.ser_s *= (1.0 + pen)
                t.work_total += 0.0
        return decision


SCHEDULERS = {
    "immsched": lambda: IMMSchedScheduler(),
    "isosched": lambda: IsoSchedScheduler(),
    "prema": lambda: LTSScheduler("prema"),
    "planaria": lambda: LTSScheduler("planaria"),
    "moca": lambda: LTSScheduler("moca"),
    "cdmsa": lambda: LTSScheduler("cdmsa"),
}


def get_scheduler(name: str) -> SchedulerBase:
    return SCHEDULERS[name]()
