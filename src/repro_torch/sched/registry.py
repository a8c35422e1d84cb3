"""Config-driven scenario registry: composable pieces behind one entry point.

Scenario construction used to be five monolithic ``make_*_scenario``
builders in :mod:`repro_torch.sched.tasks`; adding an arrival shape meant
editing that file. This module splits the construction into small
registered pieces — arrival processes, workload pools, urgency and
deadline policies, restart schedules — each registered by name in a
:class:`Registry` and composed by :func:`build_scenario` from a plain
spec dict::

    build_scenario({
        "name": "demo", "seed": 7, "horizon": 0.5,
        "streams": [{
            "arrival":  {"kind": "burst", "rate_hz": 30,
                         "burst_size": 4, "burst_frac": 0.5},
            "workload": {"kind": "uniform", "complexity": "simple"},
            "urgency":  {"kind": "bernoulli", "urgent_frac": 0.3},
            "deadline": {"kind": "slack"},
        }],
        "restarts": {"kind": "at", "times": [0.25]},
    })

Multiple ``streams`` entries share ONE ``np.random.default_rng(seed)``
consumed sequentially (stream order matters), which is exactly how the
legacy mixed-burst builder interleaved its churn phase — the thin
presets in ``tasks.py`` are byte-identical to their historical output
because every piece draws the RNG in the same order the monolithic
loops did. ``"stream": True`` returns a generator-backed
:class:`~repro_torch.sched.tasks.StreamScenario` instead of materializing the
task list (single stream only; the factory recreates the RNG per replay
so the stream is deterministic).

A spec may instead name a preset: ``build_scenario({"preset": "burst",
"args": {...}})`` delegates to the corresponding ``make_*`` builder.

Numpy copy of the JAX package's ``sched/registry.py``: every piece draws
the shared generator in the reference's order, so the golden digests of
the reference's scenarios hold for the port's.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.sched.tasks import Scenario, StreamScenario, TaskSpec
from repro_torch.workloads.zoo import get_workload, workload_complexity_class


class Registry:
    """Name → builder mapping with decorator registration.

    The ``_MODEL_BUILDERS`` idiom: pieces self-register under a string
    ``kind`` and are instantiated from spec dicts via :meth:`build`,
    so new arrival/workload/urgency/deadline/restart shapes plug in
    without touching the composition code."""

    def __init__(self, kind: str):
        self.kind = kind
        self._builders: Dict[str, Callable] = {}

    def register(self, name: str) -> Callable:
        """Decorator: register ``fn`` as the builder for ``name``."""
        def deco(fn):
            if name in self._builders:
                raise ValueError(
                    f"duplicate {self.kind} builder {name!r}")
            self._builders[name] = fn
            return fn
        return deco

    def get(self, name: str) -> Callable:
        """The registered builder, or ValueError listing known names."""
        try:
            return self._builders[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} kind {name!r}; "
                f"known: {self.names()}") from None

    def names(self) -> List[str]:
        """Sorted registered names (introspection + error messages)."""
        return sorted(self._builders)

    def build(self, spec: Dict, *args):
        """Instantiate from a spec dict: ``{"kind": name, **params}``.

        Positional ``args`` (e.g. the shared RNG and horizon for
        arrival processes) are passed through ahead of the spec's
        keyword parameters."""
        params = dict(spec)
        kind = params.pop("kind", None)
        if kind is None:
            raise ValueError(
                f"{self.kind} spec needs a 'kind' key: {spec!r}")
        return self.get(kind)(*args, **params)


#: Arrival processes: ``builder(rng, horizon, **params)`` yielding
#: :class:`ArrivalEvent`\ s with nondecreasing ``t < horizon``.
ARRIVALS = Registry("arrival")
#: Workload pools: ``builder(**params)`` returning
#: ``draw(rng, event, i) -> WorkloadGraph`` for task ``i`` of an event.
WORKLOADS = Registry("workload")
#: Urgency policies: ``builder(**params)`` returning ``draw(rng) -> bool``.
#: ``never``/``always`` consume NO randomness (draw-order fidelity).
URGENCY = Registry("urgency")
#: Deadline policies: ``builder(**params)`` returning
#: ``fn(t, workload, urgent) -> absolute deadline``.
DEADLINES = Registry("deadline")
#: Restart schedules: ``builder(**params)`` returning a transform
#: ``(tasks, horizon) -> (tasks, horizon, restart_times)``.
RESTARTS = Registry("restarts")


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One arrival instant: ``count`` tasks land at time ``t``;
    ``burst`` marks compound (multi-task) events so workload pools can
    treat burst members differently (the mixed easy/hard burst)."""
    t: float
    count: int
    burst: bool


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

@ARRIVALS.register("poisson")
def _poisson_arrivals(rng, horizon, *, rate_hz):
    """Plain Poisson point process: one task per exponential gap.

    Draws ONLY the inter-arrival gap — no burst coin — matching the
    historical non-bursty loop draw-for-draw."""
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_hz)
        if t >= horizon:
            return
        yield ArrivalEvent(t, 1, False)


@ARRIVALS.register("burst")
def _burst_arrivals(rng, horizon, *, rate_hz, burst_size, burst_frac):
    """Compound Poisson: each event flips a ``burst_frac`` coin; heads
    delivers ``burst_size`` simultaneous tasks (multi-tenant fan-in).
    The coin is drawn on EVERY event, even when it comes up tails —
    the draw order the legacy bursty loops used."""
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_hz)
        if t >= horizon:
            return
        if rng.random() < burst_frac:
            yield ArrivalEvent(t, int(burst_size), True)
        else:
            yield ArrivalEvent(t, 1, False)


@ARRIVALS.register("trace")
def _trace_arrivals(rng, horizon, *, times, counts=None):
    """Deterministic replay of explicit arrival instants (no RNG).

    ``times`` must be nondecreasing; ``counts`` optionally sizes each
    event (default 1 task). Events at or past the horizon are dropped,
    mirroring the generative processes."""
    prev = float("-inf")
    for i, t in enumerate(times):
        t = float(t)
        if t < prev:
            raise ValueError("trace arrival times must be nondecreasing")
        prev = t
        if t >= horizon:
            continue
        c = 1 if counts is None else int(counts[i])
        yield ArrivalEvent(t, c, c > 1)


# ---------------------------------------------------------------------------
# workload pools
# ---------------------------------------------------------------------------

@WORKLOADS.register("uniform")
def _uniform_pool(*, complexity):
    """Uniform draw over one complexity class (paper §4.1.2)."""
    pool = workload_complexity_class(complexity)

    def draw(rng, event, i):
        return pool[rng.integers(len(pool))]
    return draw


@WORKLOADS.register("mixed_burst")
def _mixed_burst_pool(*, easy, hard, hard_frac, burst_size):
    """Heterogeneous burst pool: the first ``round(hard_frac *
    burst_size)`` members of a burst event (at least one when
    ``hard_frac > 0``) come from the ``hard`` class, the rest — and all
    non-burst arrivals — from ``easy``. The mixed-burst stress shape
    the tiered matcher pipeline is benchmarked on."""
    easy_pool = workload_complexity_class(easy)
    hard_pool = workload_complexity_class(hard)
    n_hard = max(int(round(hard_frac * burst_size)), 1) \
        if hard_frac > 0 else 0

    def draw(rng, event, i):
        pool = hard_pool if (event.burst and i < n_hard) else easy_pool
        return pool[rng.integers(len(pool))]
    return draw


@WORKLOADS.register("named")
def _named_workload(*, name):
    """A single fixed workload by zoo name — consumes no randomness."""
    wl = get_workload(name)

    def draw(rng, event, i):
        return wl
    return draw


# ---------------------------------------------------------------------------
# urgency policies
# ---------------------------------------------------------------------------

@URGENCY.register("bernoulli")
def _bernoulli_urgency(*, urgent_frac):
    """Each task is urgent with probability ``urgent_frac`` (one
    ``rng.random()`` per task)."""
    def draw(rng):
        return rng.random() < urgent_frac
    return draw


@URGENCY.register("never")
def _never_urgent():
    """All tasks background. Consumes NO randomness — composing this
    with any workload pool reproduces loops that never drew an urgency
    coin (the legacy mixed-burst main phase)."""
    def draw(rng):
        return False
    return draw


@URGENCY.register("always")
def _always_urgent():
    """All tasks urgent, no randomness consumed (the legacy
    fragmentation-churn phase)."""
    def draw(rng):
        return True
    return draw


# ---------------------------------------------------------------------------
# deadline policies
# ---------------------------------------------------------------------------

@DEADLINES.register("slack")
def _slack_deadline(*, deadline_slack=2.0, urgent_slack=1.25,
                    base_exec_estimate=5e-3):
    """Slack × nominal-execution-estimate deadlines (paper §4.1.2):
    urgent tasks get the tighter ``urgent_slack`` multiplier."""
    def fn(t, wl, urgent):
        slack = urgent_slack if urgent else deadline_slack
        nominal = base_exec_estimate * (wl.total_macs / 1e9 + 0.2)
        return t + slack * nominal + 1e-3
    return fn


@DEADLINES.register("fixed")
def _fixed_deadline(*, offset):
    """Constant-offset deadlines: ``arrival + offset`` regardless of
    workload size or urgency."""
    def fn(t, wl, urgent):
        return t + float(offset)
    return fn


# ---------------------------------------------------------------------------
# restart schedules
# ---------------------------------------------------------------------------

@RESTARTS.register("none")
def _no_restarts():
    """No scheduler kill/restart events."""
    def transform(tasks, horizon):
        return tasks, horizon, []
    return transform


@RESTARTS.register("at")
def _restarts_at(*, times):
    """Kill/restart the scheduler process at explicit instants.

    Leaves the task list and horizon untouched, so it composes with
    streaming scenarios."""
    def transform(tasks, horizon):
        return tasks, horizon, [float(x) for x in times]
    return transform


@RESTARTS.register("replay")
def _replay_restarts(*, gap=1e-3):
    """Kill at ``horizon + gap`` and replay the EXACT same traffic
    shifted after the kill (the warm-restart stress shape): every
    phase-2 arrival is a repeat the scheduler has already solved.
    Requires a materialized task list (``needs_materialized``)."""
    def transform(tasks, horizon):
        kill_at = horizon + gap
        replay = [dataclasses.replace(t, arrival=t.arrival + kill_at,
                                      deadline=t.deadline + kill_at)
                  for t in tasks]
        return tasks + replay, 2 * horizon + gap, [kill_at]
    transform.needs_materialized = True
    return transform


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def _stream_tasks(rng, horizon: float, stream_spec: Dict
                  ) -> Iterator[TaskSpec]:
    """Tasks of one stream definition, drawn from the shared ``rng``.

    Per arrival event, per member ``i``: workload draw, urgency draw,
    deadline computation — the exact per-task draw order of every
    legacy builder loop. ``task_id`` is left at -1 for the scenario /
    simulator to assign in arrival order."""
    wl_draw = WORKLOADS.build(stream_spec["workload"])
    urg_draw = URGENCY.build(stream_spec.get("urgency", {"kind": "never"}))
    ddl = DEADLINES.build(stream_spec.get("deadline", {"kind": "slack"}))
    for ev in ARRIVALS.build(stream_spec["arrival"], rng, horizon):
        for i in range(ev.count):
            wl = wl_draw(rng, ev, i)
            urgent = bool(urg_draw(rng))
            yield TaskSpec(
                name=wl.name, workload=wl, arrival=float(ev.t),
                priority=2 if urgent else 1,
                deadline=float(ddl(ev.t, wl, urgent)),
                urgent=urgent)


def _generate(spec: Dict, rng) -> Iterator[TaskSpec]:
    """All streams of a spec, sequentially, off ONE shared rng."""
    horizon = float(spec["horizon"])
    for stream_spec in spec["streams"]:
        yield from _stream_tasks(rng, horizon, stream_spec)


def _expected_arrivals(spec: Dict) -> int:
    """Rate × horizon estimate for streaming specs (informational;
    benchmarks report it next to the exact admitted count)."""
    horizon = float(spec["horizon"])
    total = 0.0
    for s in spec["streams"]:
        a = s["arrival"]
        if a["kind"] == "poisson":
            total += a["rate_hz"] * horizon
        elif a["kind"] == "burst":
            total += a["rate_hz"] * horizon * \
                (1 + (a["burst_size"] - 1) * a["burst_frac"])
        elif a["kind"] == "trace":
            counts = a.get("counts")
            total += sum(
                (counts[i] if counts is not None else 1)
                for i, t in enumerate(a["times"]) if float(t) < horizon)
    return int(total)


def _default_name(spec: Dict) -> str:
    parts = [f"{s['arrival']['kind']}-{s['workload']['kind']}"
             for s in spec["streams"]]
    name = "+".join(parts)
    return name + "-stream" if spec.get("stream") else name


def scenario_preset(name: str) -> Callable:
    """Resolve a named scenario preset (the legacy ``make_*`` builders).

    Resolution is lazy — the presets live in :mod:`repro_torch.sched.tasks`,
    which itself composes through this module, so neither module imports
    the other at import time."""
    from repro_torch.sched import tasks as _tasks
    presets = {
        "poisson": _tasks.make_scenario,
        "burst": _tasks.make_burst_scenario,
        "mixed_burst": _tasks.make_mixed_burst_scenario,
        "restart": _tasks.make_restart_scenario,
        "streaming": _tasks.make_streaming_scenario,
    }
    try:
        return presets[name]
    except KeyError:
        raise ValueError(f"unknown scenario preset {name!r}; "
                         f"known: {sorted(presets)}") from None


#: Preset names resolvable through ``build_scenario({"preset": ...})``.
SCENARIO_PRESET_NAMES: Tuple[str, ...] = (
    "poisson", "burst", "mixed_burst", "restart", "streaming")


def build_scenario(spec: Dict):
    """Compose a :class:`Scenario` / :class:`StreamScenario` from a spec.

    Spec keys: ``streams`` (list of ``{"arrival", "workload",
    "urgency", "deadline"}`` piece specs — urgency defaults to
    ``never``, deadline to ``slack``), ``horizon``, ``seed``,
    optional ``name``, ``restarts`` (restart-schedule spec, default
    ``none``), ``stream`` (bool: generator-backed scenario;
    single-stream, non-``replay`` restarts only) and
    ``expected_arrivals`` (streaming estimate override). Alternatively
    ``{"preset": name, "args": {...}}`` delegates to a legacy
    ``make_*`` builder. All streams consume one shared
    ``np.random.default_rng(seed)`` in order."""
    if "preset" in spec:
        spec = dict(spec)
        preset = scenario_preset(spec.pop("preset"))
        kwargs = dict(spec.pop("args", {}))
        if spec:
            raise ValueError(
                f"unexpected keys alongside 'preset': {sorted(spec)}")
        return preset(**kwargs)

    horizon = float(spec["horizon"])
    seed = int(spec.get("seed", 0))
    streams = list(spec.get("streams", []))
    if not streams:
        raise ValueError("spec needs at least one entry in 'streams'")
    transform = RESTARTS.build(spec.get("restarts") or {"kind": "none"})
    name = spec.get("name") or _default_name(spec)

    if spec.get("stream"):
        if len(streams) != 1:
            raise ValueError(
                "streaming scenarios take exactly one stream; "
                "materialize multi-stream specs instead")
        if getattr(transform, "needs_materialized", False):
            raise ValueError(
                "restart policy %r rewrites the task list and cannot "
                "back a streaming scenario" % spec["restarts"]["kind"])
        _, _, restart_times = transform([], horizon)
        exp = spec.get("expected_arrivals")
        if exp is None:
            exp = _expected_arrivals(spec)
        frozen = {"horizon": horizon,
                  "streams": copy.deepcopy(streams)}

        def factory() -> Iterator[TaskSpec]:
            return _generate(frozen, np.random.default_rng(seed))

        return StreamScenario(
            name=name, horizon=horizon, arrivals_factory=factory,
            restarts=restart_times, expected_arrivals=exp)

    rng = np.random.default_rng(seed)
    tasks = list(_generate(spec, rng))
    tasks, horizon, restart_times = transform(tasks, horizon)
    return Scenario(name=name, tasks=tasks, horizon=horizon,
                    restarts=restart_times)
