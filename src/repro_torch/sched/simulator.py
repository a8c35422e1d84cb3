"""Event-driven multi-DNN accelerator simulator.

Models the engine array executing a timed stream of DNN tasks under a
pluggable scheduler. Work accounting per task uses two buckets derived from
the cost model for the scheduler's paradigm (TSS/LTS):

  * a *parallel* bucket in engine-seconds (compute; drains at a rate equal
    to the number of allocated engines, capped by the task's parallelism),
  * a *serial* bucket in seconds (DRAM round-trips for LTS, residual NoC
    serialization for TSS; drains at rate 1 while the task holds engines).

Scheduling itself has latency and energy (the paper's subject): a decision
made at time t with scheduling latency L delays the task's start to t+L
(an *activation* event); at activation the scheduler dispatches without
further cost. Serial CPU schedulers additionally contend for the single
host CPU via their own ``cpu_free_at`` bookkeeping.

Arrival events are *coalesced*: every task arriving at the same instant
(compound-Poisson bursts) is delivered to the scheduler in ONE
``on_event(trigger="arrival", arrived=[...])`` call, so batching-aware
schedulers (IMMSched's coalesced matcher launches) can make one decision
for the whole burst and pay its latency once. Latency within a burst is
*per-tier*: the scheduler may charge different members of one event
different delays (IMMSched charges revalidated Tier-0/1 decisions the
cheap projection cost and only the hard residue a swarm launch), which
``_apply`` honours per task via the decision's ``delay`` map.

Energy: execution energy is charged pro-rata with drained work (preemption
context-motion costs are folded into the task's buckets and energy);
idle-engine leakage and scheduling energy are integrated on top.

Streaming event loop
--------------------
``Simulator.run`` consumes ``scenario.arrivals_iter()`` with one-spec
lookahead, so a :class:`~repro_torch.sched.tasks.StreamScenario` replays
millions of arrivals while the simulator only ever holds the *live*
tasks (ready + running) in a :class:`TaskTable`. Event sources and their
per-event cost:

  * **arrival** — the buffered head of the arrival stream (the generator
    is the sorted queue);
  * **activation** — a lazy-deletion min-heap fed by ``_apply`` whenever
    a decision delays a task (stale entries — task finished, re-delayed,
    or already past — are discarded at peek time);
  * **completion** — recomputed each event over the running set, which
    the global-occupancy invariant bounds by the engine count. A heap of
    stored completion *timestamps* would be wrong twice over: every
    elapsed ``dt`` drains work from every running task (invalidating all
    entries anyway), and a stored ``t_alloc + remaining`` differs
    *bitwise* from the legacy loop's per-event
    ``now + remaining_time(...)`` recomputation under float rounding;
  * **restart** — a deque of scenario kill/restart instants.

This replaces the legacy loop's per-iteration O(n)-in-all-tasks
``next_completion`` / ``next_activation`` scans with per-event work
bounded by the engine count, independent of scenario length. The legacy
full-scan loop is retained as :meth:`Simulator.run_legacy` (list
scenarios only) purely as an equivalence oracle: both loops produce
bitwise-identical ``SimResult``\\ s.

The port's simulator is the JAX package's ``sched/simulator.py`` with the
same float64 arithmetic in the same order (plain Python floats and numpy,
never a torch tensor), so an analytic run is the reference's bit for bit.
``SimConfig.device`` is where IMMSched's matcher service runs: ``"cuda"``
unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import dataclasses
import heapq
from array import array
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.accel.energy import CostModel
from repro_torch.accel.platform import Platform
from repro_torch.core.pso import PSOConfig
from repro_torch.sched.tasks import Scenario, TaskSpec

_EPS = 1e-12


@dataclasses.dataclass
class SimConfig:
    platform: Platform
    matcher_mode: str = "analytic"     # "analytic" | "real"
    pso_cfg: PSOConfig = dataclasses.field(
        default_factory=lambda: PSOConfig(num_particles=32, epochs=2,
                                          inner_steps=8))
    window_stages: int = 4
    seed: int = 0
    # Warm-restart persistence root. Only None (a scenario restart event
    # is a COLD restart: all host state lost) until the port has
    # persistence; any other value raises instead of restarting cold.
    persist_dir: Optional[str] = None
    # Event budget: a run that still has events pending when the budget
    # is exhausted stops and sets ``SimResult.truncated`` instead of
    # silently reading as complete. None = unbounded.
    max_events: Optional[int] = 500_000
    # Pay for per-event invariant checks (engine occupancy disjoint,
    # finish >= arrival, busy_integral <= engines * now) — property
    # tests run with this on; benchmarks leave it off.
    validate: bool = False
    # Device of IMMSched's matcher service: the card unless the caller
    # asks for "cpu"; without a card the service raises.
    device: str = "cuda"

    def __post_init__(self):
        if self.persist_dir is not None:
            raise NotImplementedError(
                "SimConfig.persist_dir: warm-restart persistence is not "
                "ported yet (ROADMAP Queue 1 item 7); leave it None for a "
                "cold restart")


@dataclasses.dataclass
class TaskState:
    spec: TaskSpec
    par_es: float                  # engine-seconds remaining
    ser_s: float                   # serial seconds remaining
    par_cap: int
    energy_total: float            # execution energy (grows w/ preemptions)
    work_total: float              # par_es + ser_s incl. added costs
    engines: List[int] = dataclasses.field(default_factory=list)
    status: str = "pending"        # pending|ready|running|done
    ready_at: float = 0.0
    finish: float = -1.0
    sched_time: float = 0.0        # accumulated scheduling latency it saw
    live_bytes: float = 0.0

    @property
    def done(self) -> bool:
        return self.status == "done"

    def remaining_time(self, engines: int) -> float:
        if engines <= 0:
            return float("inf")
        rate = min(engines, self.par_cap)
        return self.par_es / rate + self.ser_s

    def add_cost(self, dt: float, de: float) -> None:
        self.ser_s += dt
        self.work_total += dt
        self.energy_total += de


class TaskTable:
    """Live-task view handed to schedulers by the streaming loop.

    Holds only arrived-and-unfinished tasks, keyed by ``task_id``, in
    insertion (= arrival = id) order — so scheduler-side iteration and
    ``tasks[tid]`` indexing behave exactly like the legacy full task
    list, minus the pending/done entries schedulers have no business
    reading. Finished tasks are removed right after their completion
    event, which is what keeps memory bounded by the number of live
    tasks rather than the scenario length.
    """

    def __init__(self):
        self._by_id: Dict[int, TaskState] = {}

    def add(self, t: TaskState) -> None:
        self._by_id[t.spec.task_id] = t

    def pop(self, tid: int) -> TaskState:
        return self._by_id.pop(tid)

    def get(self, tid: int) -> Optional[TaskState]:
        return self._by_id.get(tid)

    def __getitem__(self, tid: int) -> TaskState:
        return self._by_id[tid]

    def __contains__(self, tid: int) -> bool:
        return tid in self._by_id

    def __iter__(self) -> Iterator[TaskState]:
        return iter(self._by_id.values())

    def __len__(self) -> int:
        return len(self._by_id)


@dataclasses.dataclass
class SimResult:
    scheduler: str
    platform: str
    finished: int
    total: int
    deadline_met: int
    urgent_total: int
    urgent_met: int
    avg_total_latency: float       # mean (finish - arrival) over finished
    avg_sched_time: float
    total_energy: float            # J (exec + sched + idle)
    sched_energy: float
    exec_energy: float
    idle_energy: float
    sim_horizon: float
    # online matcher-service counters (compile-cache / warm-start hits,
    # epochs saved by early exit); empty for schedulers without a service
    matcher_stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    # True when the run stopped on SimConfig.max_events with events still
    # pending — numbers below are then a PREFIX of the scenario, not a
    # completed run. Benchmarks must refuse to report truncated results.
    truncated: bool = False
    events: int = 0                # simulator events processed
    # engines the simulator refused to hand out because a running task
    # already held them (scheduler decision bug; see Simulator._apply)
    alloc_conflicts: int = 0
    busy_integral: float = 0.0     # engine-seconds of occupied engines
    peak_live_tasks: int = 0       # max simultaneously live (ready+running)
    # latency_p50/p99/p999 + sched_p50/p99/p999 over finished tasks
    # (seconds); empty when nothing finished
    percentiles: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def urgent_hit_rate(self) -> float:
        return self.urgent_met / max(self.urgent_total, 1)

    @property
    def all_hit_rate(self) -> float:
        return self.deadline_met / max(self.total, 1)

    @property
    def tasks_per_joule(self) -> float:
        return self.finished / max(self.total_energy, 1e-12)

    @property
    def met_per_joule(self) -> float:
        """Deadline-meeting throughput per joule — the paper's energy
        efficiency: queries that *count* (served within their latency
        bound) per unit energy. A floor of 1/4 task avoids div-by-zero
        for baselines that miss every deadline at saturating load."""
        return max(self.deadline_met, 0.25) / max(self.total_energy, 1e-12)

    @property
    def work_energy_per_task(self) -> float:
        """Exec + scheduling energy per finished task (paper's energy
        metric: the per-query cost, excluding array idle leakage)."""
        return (self.exec_energy + self.sched_energy) / max(self.finished, 1)


def _finish_percentiles(lat: np.ndarray, st: np.ndarray) -> Dict[str, float]:
    """p50/p99/p999 of total latency and scheduling time (seconds)."""
    if lat.size == 0:
        return {}
    out: Dict[str, float] = {}
    for name, arr in (("latency", lat), ("sched", st)):
        for q, tag in ((50.0, "p50"), (99.0, "p99"), (99.9, "p999")):
            out[f"{name}_{tag}"] = float(np.percentile(arr, q))
    return out


class Simulator:
    def __init__(self, cfg: SimConfig, scheduler):
        self.cfg = cfg
        self.platform = cfg.platform
        self.scheduler = scheduler
        self.cost = CostModel(cfg.platform)
        self._alloc_conflicts = 0

    # ------------------------------------------------------------------
    def run(self, scenario) -> SimResult:
        """Streaming heap-scheduled event loop.

        Accepts any scenario exposing ``arrivals_iter()`` / ``horizon``
        (list-based :class:`Scenario` and generator-backed
        :class:`StreamScenario` alike); per-event cost is bounded by the
        engine count, memory by the live-task count. Bitwise-equivalent
        to :meth:`run_legacy` on list scenarios.
        """
        sched = self.scheduler
        sched.reset(self)
        self._alloc_conflicts = 0
        stream = scenario.arrivals_iter()
        next_spec: Optional[TaskSpec] = next(stream, None)
        table = TaskTable()
        running_ids: set = set()
        act_heap: List[Tuple[float, int]] = []
        restarts = deque(getattr(scenario, "restarts", ()))
        now = 0.0
        busy_integral = 0.0
        sched_energy = 0.0
        exec_energy = 0.0
        horizon = scenario.horizon * 4 + 1.0
        max_events = self.cfg.max_events
        validate = self.cfg.validate
        admitted = 0
        urgent_total = 0
        n_finished = 0
        deadline_met = 0
        urgent_met = 0
        peak_live = 0
        events = 0
        truncated = False
        # compact per-finished-task stats (8 bytes/entry, not a TaskState)
        fin_ids = array("q")
        fin_lat = array("d")
        fin_st = array("d")

        while True:
            t_arr = next_spec.arrival if next_spec is not None \
                else float("inf")
            # completion: recompute over the engine-bounded running set in
            # id order — strict < keeps the earliest id on ties, exactly
            # like the legacy full scan (and unlike a stored-timestamp
            # heap, recomputation matches its float rounding bitwise)
            t_done, done_task = float("inf"), None
            for tid in sorted(running_ids):
                t = table[tid]
                rt = t.remaining_time(len(t.engines))
                if now + rt < t_done:
                    t_done, done_task = now + rt, t
            # activation: lazy-deletion heap; entries are (ready_at, tid)
            # pushed by _apply at delay time. Stale when the task is gone
            # or no longer ready, was re-delayed past this entry, or the
            # instant is not in the future (<= now+eps never activates —
            # such tasks dispatch on the next ordinary event instead,
            # matching the legacy scan's `ready_at > now + eps` filter).
            t_act = float("inf")
            while act_heap:
                when, tid = act_heap[0]
                t = table.get(tid)
                if (t is None or t.status != "ready"
                        or when != t.ready_at or when <= now + _EPS):
                    heapq.heappop(act_heap)
                    continue
                t_act = when
                break
            t_res = restarts[0] if restarts else float("inf")
            t_next = min(t_arr, t_done, t_act, t_res)
            if t_next == float("inf") or t_next > horizon:
                break
            if max_events is not None and events >= max_events:
                truncated = True
                break
            events += 1
            # ---- advance time, drain work, integrate energy ----
            dt = t_next - now
            if dt > 0:
                for tid in sorted(running_ids):
                    t = table[tid]
                    rate = min(len(t.engines), t.par_cap)
                    drain_par = min(t.par_es, rate * dt)
                    t.par_es -= drain_par
                    left = dt - drain_par / max(rate, 1)
                    drain_ser = min(t.ser_s, max(left, 0.0))
                    t.ser_s -= drain_ser
                    exec_energy += t.energy_total * (
                        drain_par + drain_ser) / max(t.work_total, _EPS)
                    busy_integral += len(t.engines) * dt
                now = t_next

            if t_res <= min(t_arr, t_done, t_act):
                # scheduler-process kill/restart: host state dies; tasks
                # running on the accelerator are unaffected. Restarts outrank
                # same-instant arrivals so those arrivals hit the
                # restarted (worst-case cold) scheduler.
                restarts.popleft()
                sched.on_restart(self, now)
                continue
            completed: Optional[TaskState] = None
            if t_done <= min(t_arr, t_act) and done_task is not None:
                done_task.par_es = max(done_task.par_es, 0.0)
                done_task.ser_s = max(done_task.ser_s, 0.0)
                done_task.status = "done"
                done_task.finish = now
                done_task.engines = []
                running_ids.discard(done_task.spec.task_id)
                completed = done_task
                n_finished += 1
                if done_task.finish <= done_task.spec.deadline:
                    deadline_met += 1
                    if done_task.spec.urgent:
                        urgent_met += 1
                fin_ids.append(done_task.spec.task_id)
                fin_lat.append(done_task.finish - done_task.spec.arrival)
                fin_st.append(done_task.sched_time)
                if validate:
                    assert done_task.finish >= done_task.spec.arrival, \
                        f"task {done_task.spec.task_id} finished before " \
                        f"arriving"
                dec = sched.on_event(self, now, table, trigger="completion")
            elif t_arr <= min(t_done, t_act):
                # one event delivers ALL tasks that became schedulable at
                # this instant (burst arrivals coalesce into one decision)
                arrived = []
                while next_spec is not None \
                        and next_spec.arrival <= now + _EPS:
                    next_spec.task_id = admitted
                    ts = self._admit(next_spec)
                    ts.status = "ready"
                    ts.ready_at = now
                    table.add(ts)
                    admitted += 1
                    if next_spec.urgent:
                        urgent_total += 1
                    arrived.append(ts)
                    next_spec = next(stream, None)
                peak_live = max(peak_live, len(table))
                dec = sched.on_event(self, now, table, trigger="arrival",
                                     arrived=arrived)
            else:
                dec = sched.on_event(self, now, table, trigger="activate")
            sched_energy += self._apply(dec, table, now, act_heap=act_heap)
            # reconcile the running set with what the decision did
            if dec:
                for tid in dec.get("preempt", []):
                    t = table.get(tid)
                    if t is None or t.status != "running":
                        running_ids.discard(tid)
                for tid in dec.get("alloc", {}):
                    t = table.get(tid)
                    if t is not None and t.status == "running":
                        running_ids.add(tid)
            if completed is not None:
                table.pop(completed.spec.task_id)
            if validate:
                seen: set = set()
                for tid in running_ids:
                    es = set(table[tid].engines)
                    assert not (seen & es), \
                        f"engines {seen & es} double-booked at t={now}"
                    seen |= es
                assert busy_integral <= \
                    self.platform.engines * now + 1e-9, \
                    "busy_integral exceeds engines*now"

        idle_energy = (self.platform.engines * now - busy_integral) \
            * self.cost.engine_idle_watts
        total_energy = exec_energy + sched_energy + max(idle_energy, 0.0)
        # order finished-task stats by task id so float summation order
        # (np.mean pairwise over the array) matches the legacy loop's
        # id-ordered list bitwise
        order = np.argsort(np.asarray(fin_ids, dtype=np.int64),
                           kind="stable")
        lat = np.asarray(fin_lat, dtype=np.float64)[order]
        st = np.asarray(fin_st, dtype=np.float64)[order]
        result = SimResult(
            scheduler=sched.name, platform=self.platform.name,
            finished=n_finished, total=admitted,
            deadline_met=deadline_met, urgent_total=urgent_total,
            urgent_met=urgent_met,
            avg_total_latency=float(np.mean(lat)) if lat.size
            else float("inf"),
            avg_sched_time=float(np.mean(st)) if st.size else 0.0,
            total_energy=total_energy, sched_energy=sched_energy,
            exec_energy=exec_energy, idle_energy=max(idle_energy, 0.0),
            sim_horizon=now,
            matcher_stats=sched.matcher_stats(),
            truncated=truncated, events=events,
            alloc_conflicts=self._alloc_conflicts,
            busy_integral=busy_integral, peak_live_tasks=peak_live,
            percentiles=_finish_percentiles(lat, st))
        self._check_invariants(sched, result)
        return result

    # ------------------------------------------------------------------
    def run_legacy(self, scenario: Scenario) -> SimResult:
        """Legacy full-scan event loop (equivalence oracle).

        Materializes the whole task list and rescans it per event — the
        pre-streaming implementation, kept verbatim (plus the shared
        occupancy/truncation fixes) so tests can assert the streaming
        loop reproduces it bitwise on list scenarios. Requires a
        list-based :class:`Scenario`; O(n·events) — do not benchmark it.
        """
        sched = self.scheduler
        sched.reset(self)
        self._alloc_conflicts = 0
        tasks = [self._admit(spec) for spec in scenario.tasks]
        arrivals = [(t.spec.arrival, i) for i, t in enumerate(tasks)]
        heapq.heapify(arrivals)
        restarts = deque(getattr(scenario, "restarts", ()))
        now = 0.0
        busy_integral = 0.0
        sched_energy = 0.0
        exec_energy = 0.0
        horizon = scenario.horizon * 4 + 1.0
        max_events = self.cfg.max_events
        events = 0
        truncated = False
        peak_live = 0

        def running():
            return [t for t in tasks if t.status == "running"]

        def next_completion():
            best, who = float("inf"), None
            for t in running():
                rt = t.remaining_time(len(t.engines))
                if now + rt < best:
                    best, who = now + rt, t
            return best, who

        def next_activation():
            best = float("inf")
            for t in tasks:
                if t.status == "ready" and t.ready_at > now + _EPS:
                    best = min(best, t.ready_at)
            return best

        while True:
            t_arr = arrivals[0][0] if arrivals else float("inf")
            t_done, done_task = next_completion()
            t_act = next_activation()
            t_res = restarts[0] if restarts else float("inf")
            t_next = min(t_arr, t_done, t_act, t_res)
            if t_next == float("inf") or t_next > horizon:
                break
            if max_events is not None and events >= max_events:
                truncated = True
                break
            events += 1
            # ---- advance time, drain work, integrate energy ----
            dt = t_next - now
            if dt > 0:
                for t in running():
                    rate = min(len(t.engines), t.par_cap)
                    drain_par = min(t.par_es, rate * dt)
                    t.par_es -= drain_par
                    left = dt - drain_par / max(rate, 1)
                    drain_ser = min(t.ser_s, max(left, 0.0))
                    t.ser_s -= drain_ser
                    exec_energy += t.energy_total * (
                        drain_par + drain_ser) / max(t.work_total, _EPS)
                    busy_integral += len(t.engines) * dt
                now = t_next

            if t_res <= min(t_arr, t_done, t_act):
                restarts.popleft()
                sched.on_restart(self, now)
                continue
            if t_done <= min(t_arr, t_act) and done_task is not None:
                done_task.par_es = max(done_task.par_es, 0.0)
                done_task.ser_s = max(done_task.ser_s, 0.0)
                done_task.status = "done"
                done_task.finish = now
                done_task.engines = []
                dec = sched.on_event(self, now, tasks, trigger="completion")
            elif t_arr <= min(t_done, t_act):
                arrived = []
                while arrivals and arrivals[0][0] <= now + _EPS:
                    _, idx = heapq.heappop(arrivals)
                    t = tasks[idx]
                    t.status = "ready"
                    t.ready_at = now
                    arrived.append(t)
                peak_live = max(peak_live, sum(
                    1 for t in tasks if t.status in ("ready", "running")))
                dec = sched.on_event(self, now, tasks, trigger="arrival",
                                     arrived=arrived)
            else:
                dec = sched.on_event(self, now, tasks, trigger="activate")
            sched_energy += self._apply(dec, tasks, now)

        finished = [t for t in tasks if t.done]
        met = [t for t in finished if t.finish <= t.spec.deadline]
        urgent = [t for t in tasks if t.spec.urgent]
        urgent_met = [t for t in urgent
                      if t.done and t.finish <= t.spec.deadline]
        idle_energy = (self.platform.engines * now - busy_integral) \
            * self.cost.engine_idle_watts
        total_energy = exec_energy + sched_energy + max(idle_energy, 0.0)
        lat = np.asarray([t.finish - t.spec.arrival for t in finished],
                         dtype=np.float64)
        st = np.asarray([t.sched_time for t in finished],
                        dtype=np.float64)
        result = SimResult(
            scheduler=sched.name, platform=self.platform.name,
            finished=len(finished), total=len(tasks),
            deadline_met=len(met), urgent_total=len(urgent),
            urgent_met=len(urgent_met),
            avg_total_latency=float(np.mean(lat)) if lat.size
            else float("inf"),
            avg_sched_time=float(np.mean(st)) if st.size else 0.0,
            total_energy=total_energy, sched_energy=sched_energy,
            exec_energy=exec_energy, idle_energy=max(idle_energy, 0.0),
            sim_horizon=now,
            matcher_stats=sched.matcher_stats(),
            truncated=truncated, events=events,
            alloc_conflicts=self._alloc_conflicts,
            busy_integral=busy_integral, peak_live_tasks=peak_live,
            percentiles=_finish_percentiles(lat, st))
        self._check_invariants(sched, result)
        return result

    # ------------------------------------------------------------------
    def _check_invariants(self, sched, result: SimResult) -> None:
        """End-of-run scheduler cross-checks under ``cfg.validate``.

        Dispatches to the scheduler's ``check_invariants(result)`` hook
        (see :class:`~repro_torch.sched.schedulers.SchedulerBase`) on the
        finished result, from BOTH event loops — so heap and legacy
        runs are held to identical accounting invariants. Schedulers
        without the hook (ad-hoc test doubles) are skipped."""
        if not self.cfg.validate:
            return
        check = getattr(sched, "check_invariants", None)
        if check is not None:
            check(result)

    # ------------------------------------------------------------------
    def _admit(self, spec: TaskSpec) -> TaskState:
        wl = spec.workload
        paradigm = self.scheduler.paradigm
        p = self.platform
        per_engine = p.macs_per_engine * p.clock_hz * self.cost.engine_util_dnn
        par_es = wl.total_macs / per_engine
        if paradigm == "tss":
            _, e = self.cost.exec_tss(wl, max(p.engines // 2, 1))
            ser = wl.total_bytes * self.cost.avg_hops / (
                p.noc_link_bw_bytes * max(p.engines // 2, 1))
        else:
            overlap = getattr(self.scheduler, "overlap", 0.0)
            _, e = self.cost.exec_lts(wl, p.engines, overlap)
            ser = 2.0 * wl.total_bytes / p.dram_bw_bytes * (1.0 - overlap)
        depth = max(len(wl.layers) // 8, 1)
        par_cap = int(np.clip(len(wl.layers) / depth * 4, 1, p.engines))
        live = np.mean([l.bytes_moved for l in wl.layers]) * 4
        return TaskState(spec=spec, par_es=par_es, ser_s=ser,
                         par_cap=par_cap, energy_total=e,
                         work_total=par_es + ser, live_bytes=float(live))

    def _apply(self, decision, tasks, now, act_heap=None) -> float:
        """Apply a scheduler decision. ``tasks`` is indexable by task id
        and iterable over TaskStates (legacy list or TaskTable).

        Decision ``delay`` entries are the ONLY sanctioned way to move a
        task's ``ready_at`` into the future — the streaming loop's
        activation heap is fed here, so a scheduler mutating ``ready_at``
        directly would never get its activation event.
        """
        if decision is None:
            return 0.0
        for tid in decision.get("preempt", []):
            t = tasks[tid]
            if t.status == "running":
                t.status = "ready"
                t.engines = []
                dt, de = (self.cost.preemption_cost_tss(t.live_bytes)
                          if self.scheduler.paradigm == "tss" else
                          self.cost.preemption_cost_lts(t.live_bytes))
                t.add_cost(dt, de)
                if act_heap is not None and t.ready_at > now + _EPS:
                    heapq.heappush(act_heap, (t.ready_at, tid))
        # delays first: a delayed task cannot start in the same decision
        for tid, delay in decision.get("delay", {}).items():
            t = tasks[tid]
            if delay > 0:
                t.ready_at = max(t.ready_at, now + delay)
                t.sched_time += delay
                if act_heap is not None:
                    heapq.heappush(act_heap, (t.ready_at, tid))
        # global occupancy: engines held by running tasks are never
        # re-granted — a scheduler decision that tries is a bug we
        # surface via the alloc_conflicts counter instead of silently
        # double-booking the engine (ROADMAP invariant)
        occupied: set = set()
        for t in tasks:
            if t.status == "running":
                occupied.update(t.engines)
        claimed: set = set(occupied)
        for tid, engines in decision.get("alloc", {}).items():
            t = tasks[tid]
            self._alloc_conflicts += sum(1 for e in engines
                                         if e in occupied)
            engines = [e for e in engines if e not in claimed]
            if t.status == "ready" and engines and now >= t.ready_at - _EPS:
                t.status = "running"
                t.engines = list(engines)
                claimed.update(engines)
        return decision.get("energy", 0.0)
