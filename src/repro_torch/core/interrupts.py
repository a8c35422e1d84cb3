"""Interrupt-driven preemption decisions (paper §3.3, Fig. 4).

Pure decision logic, driven by the event simulator in
``repro_torch.sched`` (and usable standalone). Two policies from the paper:

  * **adaptive single-core preemption ratio** — how many engines to free for
    the urgent task, scaled by its deadline pressure;
  * **largest-slack-first victim selection** — among running tasks, preempt
    those with the most execution-time slack so preemption does not cause
    *their* deadlines to be missed.

Numpy copy of the JAX package's ``core/interrupts.py``; the port keeps its
own copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class RunningTask:
    task_id: int
    priority: int                  # higher = more urgent
    engines: List[int]             # engines currently held
    remaining_time: float          # at current allocation
    deadline: float                # absolute
    live_bytes: float = 0.0        # context that must drain on preemption

    def slack(self, now: float) -> float:
        return (self.deadline - now) - self.remaining_time


@dataclasses.dataclass
class PreemptionDecision:
    victims: List[int]                       # task ids preempted
    freed_engines: List[int]
    engines_requested: int
    preemption_ratio: float


def adaptive_preemption_ratio(urgent_exec_time: float, ddl_window: float,
                              lo: float = 0.25, hi: float = 1.0) -> float:
    """Fraction of the (busy) array the urgent task may grab.

    Pressure ≈ exec_time / available_window: a task that barely fits its
    deadline takes the whole array; a relaxed one takes a quarter.
    """
    if ddl_window <= 0:
        return hi
    pressure = urgent_exec_time / ddl_window
    return float(np.clip(lo + (hi - lo) * pressure, lo, hi))


def select_victims(running: Sequence[RunningTask], idle_engines: List[int],
                   engines_needed: int, urgent_priority: int,
                   now: float) -> PreemptionDecision:
    """Free engines for the urgent task: idle first, then preempt
    lower-priority tasks in largest-slack-first order (paper Fig. 4 — tasks
    with slack absorb preemption without deadline violations; higher-priority
    running tasks are never interrupted)."""
    freed = list(idle_engines)
    victims: List[int] = []
    if len(freed) < engines_needed:
        candidates = [t for t in running if t.priority < urgent_priority]
        candidates.sort(key=lambda t: t.slack(now), reverse=True)
        for t in candidates:
            if len(freed) >= engines_needed:
                break
            victims.append(t.task_id)
            freed.extend(t.engines)
    return PreemptionDecision(
        victims=victims, freed_engines=freed,
        engines_requested=engines_needed,
        preemption_ratio=(len(freed) and engines_needed / len(freed) or 0.0))


def engines_needed_for(n_tiles: int, max_engines: int,
                       ratio: float) -> int:
    """Engine demand of a query window of ``n_tiles`` tiles, capped by the
    adaptive preemption ratio."""
    want = min(n_tiles, max_engines)
    return max(1, min(want, int(np.ceil(max_engines * ratio))))
