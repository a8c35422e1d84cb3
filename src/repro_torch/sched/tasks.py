"""Task specifications + scenario generation for the multi-DNN simulator.

A *scenario* is a timed stream of DNN task instances: background tasks
(periodic/known, what LTS schedulers were designed for) plus *urgent* tasks
with unpredictable (Poisson) arrivals and tight deadlines — the open-ended
setting the paper targets.

Numpy copy of the JAX package's ``sched/tasks.py``: the same builders draw
the same ``np.random.default_rng`` stream in the same order, so a scenario
is the reference's byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.workloads.layers import WorkloadGraph


@dataclasses.dataclass
class TaskSpec:
    name: str
    workload: WorkloadGraph
    arrival: float
    priority: int               # higher = more urgent
    deadline: float             # absolute seconds
    urgent: bool = False
    task_id: int = -1


@dataclasses.dataclass
class Scenario:
    name: str
    tasks: List[TaskSpec]
    horizon: float
    #: Scheduler-process kill/restart instants (seconds). At each time the
    #: simulator delivers an ``on_restart`` to the scheduler: its host
    #: process state (compile caches, warm carries, predictor history,
    #: host-CPU queue) dies; tasks already running on the accelerator
    #: keep their engines. The port restarts cold: it has no warm-restart
    #: persistence yet (see ``SimConfig.persist_dir``).
    restarts: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.tasks.sort(key=lambda t: t.arrival)
        tasks = []
        for i, t in enumerate(self.tasks):
            if t.task_id not in (-1, i):
                # re-materializing tasks that already belong to another
                # scenario (registry specs, scenario surgery in tests):
                # renumber a COPY so the donor scenario's ids survive —
                # mutating foreign TaskSpecs here silently corrupted the
                # donor's task table
                t = dataclasses.replace(t, task_id=i)
            else:
                t.task_id = i
            tasks.append(t)
        self.tasks = tasks
        self.restarts = sorted(float(r) for r in self.restarts)

    def arrivals_iter(self) -> Iterator[TaskSpec]:
        """Arrival-ordered task stream — the seam the simulator's
        streaming event loop consumes. For a materialized scenario this
        just walks the (already sorted) task list; ``StreamScenario``
        provides the generator-backed equivalent."""
        return iter(self.tasks)


@dataclasses.dataclass
class StreamScenario:
    """A scenario whose tasks are *generated*, not materialized.

    ``arrivals_factory`` returns a fresh arrival-ordered
    ``Iterator[TaskSpec]`` each time ``arrivals_iter`` is called, so one
    StreamScenario can be replayed across schedulers exactly like a
    list-based :class:`Scenario` — but the simulator only ever holds the
    tasks that are currently live, which is what lets a run replay
    millions of arrivals at bounded memory. Task ids are assigned by the
    simulator in arrival order (the factory must yield tasks with
    nondecreasing ``arrival``)."""
    name: str
    horizon: float
    arrivals_factory: Callable[[], Iterator[TaskSpec]]
    restarts: List[float] = dataclasses.field(default_factory=list)
    #: rate × horizon estimate; purely informational (benchmarks report
    #: it next to the exact admitted count)
    expected_arrivals: Optional[int] = None

    def __post_init__(self):
        self.restarts = sorted(float(r) for r in self.restarts)

    def arrivals_iter(self) -> Iterator[TaskSpec]:
        """Fresh arrival-ordered generator over the task stream."""
        return self.arrivals_factory()


def _poisson_stream_spec(complexity: str, *, rate_hz: float = 20.0,
                         horizon: float = 2.0, urgent_frac: float = 0.4,
                         deadline_slack: float = 2.0,
                         urgent_slack: float = 1.25,
                         base_exec_estimate: float = 5e-3,
                         burst_size: int = 1, burst_frac: float = 0.0,
                         seed: int = 0, stream: bool = False) -> dict:
    """Registry spec for the canonical single-class Poisson stream.

    The shared core of :func:`make_scenario`,
    :func:`make_streaming_scenario` and :func:`make_restart_scenario`.
    Non-bursty knobs select the plain ``poisson`` arrival process (no
    burst coin draws), bursty knobs the compound ``burst`` one — the
    same gating the historical loop applied, so the registry path draws
    the RNG identically."""
    bursty = burst_frac > 0.0 and burst_size > 1
    arrival = ({"kind": "burst", "rate_hz": rate_hz,
                "burst_size": burst_size, "burst_frac": burst_frac}
               if bursty else {"kind": "poisson", "rate_hz": rate_hz})
    name = (f"{complexity}-burst{burst_size}" if bursty
            else f"{complexity}-poisson")
    if stream:
        name += "-stream"
    return {
        "name": name, "seed": seed, "horizon": horizon, "stream": stream,
        "streams": [{
            "arrival": arrival,
            "workload": {"kind": "uniform", "complexity": complexity},
            "urgency": {"kind": "bernoulli", "urgent_frac": urgent_frac},
            "deadline": {"kind": "slack",
                         "deadline_slack": deadline_slack,
                         "urgent_slack": urgent_slack,
                         "base_exec_estimate": base_exec_estimate},
        }],
    }


def _poisson_task_stream(complexity: str, *, rate_hz: float,
                         horizon: float, urgent_frac: float,
                         deadline_slack: float, urgent_slack: float,
                         base_exec_estimate: float, burst_size: int,
                         burst_frac: float, seed: int
                         ) -> Iterator[TaskSpec]:
    """Generator behind :func:`make_scenario` / streaming scenarios.

    Backed by the scenario registry's composed pieces, which draw the
    RNG in exactly the order the historical list-building loop did
    (inter-arrival gap, burst coin, then per-task workload/urgency
    draws), so ``list(_poisson_task_stream(...))`` is byte-identical to
    the tasks of the materialized scenario with the same knobs — the
    property ``make_streaming_scenario`` relies on. Yields tasks with
    nondecreasing ``arrival``; ``task_id`` is left at -1 for the
    simulator to assign in arrival order."""
    from repro_torch.sched.registry import _generate
    spec = _poisson_stream_spec(
        complexity, rate_hz=rate_hz, horizon=horizon,
        urgent_frac=urgent_frac, deadline_slack=deadline_slack,
        urgent_slack=urgent_slack, base_exec_estimate=base_exec_estimate,
        burst_size=burst_size, burst_frac=burst_frac, seed=seed)
    return _generate(spec, np.random.default_rng(seed))


def make_scenario(complexity: str, *, rate_hz: float = 20.0,
                  horizon: float = 2.0, urgent_frac: float = 0.4,
                  deadline_slack: float = 2.0,
                  urgent_slack: float = 1.25,
                  base_exec_estimate: float = 5e-3,
                  burst_size: int = 1, burst_frac: float = 0.0,
                  seed: int = 0) -> Scenario:
    """Poisson stream over one complexity class (paper §4.1.2).

    ``deadline_slack`` multiplies a nominal execution estimate to set
    deadlines; urgent tasks get the tighter ``urgent_slack``.

    ``burst_size``/``burst_frac`` turn the stream compound-Poisson: with
    probability ``burst_frac`` an arrival event delivers ``burst_size``
    tasks at the SAME instant (multi-tenant request fan-in — the case the
    coalescing matcher service batches into one launch). A thin preset
    over :func:`repro_torch.sched.registry.build_scenario`; the registry path
    draws exactly the legacy RNG stream, so scenarios are byte-identical
    to historical output (golden-seed tested).
    """
    from repro_torch.sched.registry import build_scenario
    return build_scenario(_poisson_stream_spec(
        complexity, rate_hz=rate_hz, horizon=horizon,
        urgent_frac=urgent_frac, deadline_slack=deadline_slack,
        urgent_slack=urgent_slack, base_exec_estimate=base_exec_estimate,
        burst_size=burst_size, burst_frac=burst_frac, seed=seed))


def make_streaming_scenario(complexity: str, *, rate_hz: float = 20.0,
                            horizon: float = 2.0,
                            urgent_frac: float = 0.4,
                            deadline_slack: float = 2.0,
                            urgent_slack: float = 1.25,
                            base_exec_estimate: float = 5e-3,
                            burst_size: int = 1,
                            burst_frac: float = 0.0,
                            seed: int = 0) -> StreamScenario:
    """Streaming twin of :func:`make_scenario`: same knobs, same RNG
    draws, but tasks are generated on demand instead of materialized, so
    ``rate_hz * horizon`` can be millions without holding millions of
    TaskSpecs. ``make_streaming_scenario(...)`` replayed through the
    simulator is byte-identical to ``make_scenario(...)`` with the same
    arguments (tested in tests/test_scale.py)."""
    from repro_torch.sched.registry import build_scenario
    bursty = burst_frac > 0.0 and burst_size > 1
    spec = _poisson_stream_spec(
        complexity, rate_hz=rate_hz, horizon=horizon,
        urgent_frac=urgent_frac, deadline_slack=deadline_slack,
        urgent_slack=urgent_slack, base_exec_estimate=base_exec_estimate,
        burst_size=burst_size, burst_frac=burst_frac, seed=seed,
        stream=True)
    spec["expected_arrivals"] = int(rate_hz * horizon *
                                    (1 + (burst_size - 1) * burst_frac
                                     if bursty else 1))
    return build_scenario(spec)


def make_burst_scenario(complexity: str, *, burst_size: int = 4,
                        burst_frac: float = 0.5, **kw) -> Scenario:
    """Compound-Poisson burst stream: a ``burst_frac`` fraction of arrival
    events deliver ``burst_size`` simultaneous tasks (PREMA's consolidated
    multi-tenant NPU setting). All other knobs pass through to
    ``make_scenario``."""
    return make_scenario(complexity, burst_size=burst_size,
                         burst_frac=burst_frac, **kw)


def make_mixed_burst_scenario(easy: str = "simple", hard: str = "complex",
                              *, rate_hz: float = 20.0,
                              horizon: float = 2.0,
                              burst_size: int = 8,
                              hard_frac: float = 0.25,
                              burst_frac: float = 0.7,
                              churn_rate_hz: float = 0.0,
                              deadline_slack: float = 2.0,
                              urgent_slack: float = 1.25,
                              base_exec_estimate: float = 5e-3,
                              seed: int = 0) -> Scenario:
    """Heterogeneous easy/hard bursts + engine-fragmentation churn.

    The stress scenario for the tiered matcher pipeline: with probability
    ``burst_frac`` an arrival event delivers ``burst_size`` simultaneous
    tasks of which a ``hard_frac`` fraction come from the ``hard``
    complexity class and the rest from ``easy`` — the mixed burst where a
    uniform batched matcher pays the hard subset's max-epochs for every
    member, but the tiered drain serves the easy majority at revalidation
    cost and sizes the swarm to the hard residue.

    ``churn_rate_hz`` adds an independent Poisson stream of small *urgent*
    ``easy``-class tasks with tight deadlines: their preemptions churn the
    free-engine set (PREMA-style fragmentation), so repeat arrivals see
    drifted platform states — exact content-keyed warm carries miss and
    only Tier-1 similarity rebases keep the warm hit rate up.
    """
    from repro_torch.sched.registry import build_scenario
    deadline = {"kind": "slack", "deadline_slack": deadline_slack,
                "urgent_slack": urgent_slack,
                "base_exec_estimate": base_exec_estimate}
    streams = [{
        # the main phase always flips the burst coin (burst_frac may be
        # 0) and never draws an urgency coin — tasks are background
        "arrival": {"kind": "burst", "rate_hz": rate_hz,
                    "burst_size": burst_size, "burst_frac": burst_frac},
        "workload": {"kind": "mixed_burst", "easy": easy, "hard": hard,
                     "hard_frac": hard_frac, "burst_size": burst_size},
        "urgency": {"kind": "never"},
        "deadline": deadline,
    }]
    if churn_rate_hz > 0:
        streams.append({
            "arrival": {"kind": "poisson", "rate_hz": churn_rate_hz},
            "workload": {"kind": "uniform", "complexity": easy},
            "urgency": {"kind": "always"},
            "deadline": deadline,
        })
    return build_scenario({
        "name": f"mixed-{easy}-{hard}-burst{burst_size}",
        "seed": seed, "horizon": horizon, "streams": streams})


def make_restart_scenario(complexity: str = "simple", *,
                          rate_hz: float = 20.0,
                          phase_horizon: float = 0.5,
                          burst_size: int = 4,
                          burst_frac: float = 0.6,
                          urgent_frac: float = 0.4,
                          restart_gap: float = 1e-3,
                          seed: int = 0, **kw) -> Scenario:
    """Kill/restart stress scenario: identical traffic before and after.

    Phase 1 is a compound-Poisson burst stream over ``[0,
    phase_horizon)``; the scheduler process is killed at
    ``phase_horizon`` (+ ``restart_gap``, so in-flight same-instant
    arrivals land before the kill) and phase 2 **replays the exact same
    workloads and burst pattern** shifted after the restart. Every
    phase-2 arrival is therefore a repeat the scheduler has already
    solved. The port's scheduler restarts cold and pays the full
    first-arrival path again; a warm restart, which would serve them
    from restored carries at revalidation cost, needs the persistence
    the port does not have yet.

    Extra ``kw`` pass through to :func:`make_scenario` (both phases).
    """
    from repro_torch.sched.registry import build_scenario
    spec = _poisson_stream_spec(
        complexity, rate_hz=rate_hz, horizon=phase_horizon,
        urgent_frac=urgent_frac, burst_size=burst_size,
        burst_frac=burst_frac, seed=seed, **kw)
    spec["name"] += "-restart"
    spec["restarts"] = {"kind": "replay", "gap": restart_gap}
    return build_scenario(spec)


def fixed_scenario(workloads: Sequence[WorkloadGraph], *,
                   spacing: float = 1e-3,
                   urgent_last: bool = True,
                   deadline_slack: float = 3.0,
                   base_exec_estimate: float = 5e-3) -> Scenario:
    """Deterministic small scenario (tests + speedup benchmark): background
    tasks arrive at t≈0, one urgent task arrives mid-flight."""
    tasks = []
    for i, wl in enumerate(workloads):
        urgent = urgent_last and (i == len(workloads) - 1)
        arrival = 0.0 + i * spacing if not urgent else 0.5e-3 + i * spacing
        nominal = base_exec_estimate * (wl.total_macs / 1e9 + 0.2)
        tasks.append(TaskSpec(
            name=wl.name, workload=wl, arrival=arrival,
            priority=2 if urgent else 1,
            deadline=arrival + deadline_slack * nominal + 1e-3,
            urgent=urgent))
    horizon = max(t.deadline for t in tasks) * 4.0
    return Scenario(name="fixed", tasks=tasks, horizon=horizon)
