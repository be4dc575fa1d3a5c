"""Fault injection for the training loop: the port of the JAX package's
``resilience/faults.py``.

A five-day run on 256 cards (the paper's setting) gets preempted, loses
hosts and stalls on stragglers. The trainer's ``step_hook`` seam is called
with the global step index just before that step runs, and this module
provides the faults to plug into it:

  * **kill**: raise ``SimulatedFault`` before step ``kill_at``; the run
    dies with whatever checkpoints it has written. Recovery is a FRESH
    experiment restoring the latest full-state snapshot and re-running
    the lost steps.
  * **delay**: sleep ``delay_s`` before step ``delay_at`` (a straggler).
    The numerics must not move; only the wall-clock does.

Where the kill lands is the scenario: between checkpoints (the work since
the last snapshot is replayed), mid-refresh-interval (the knn graph or
LSH tables in the snapshot are stale relative to the params exactly as in
the killed run, and the restore must not rebuild them), and after DGC
has accumulated (u and v are mid-flight and must ride the snapshot).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional


class SimulatedFault(RuntimeError):
    """An injected process death. Escapes the training loop as a real
    SIGKILL would: nothing after the loop runs."""


@dataclass(frozen=True)
class FaultPlan:
    """When to hurt the run. ``kill_at`` / ``delay_at`` are global step
    indices (the value the trainer's ``step_hook`` receives)."""
    kill_at: Optional[int] = None
    delay_at: Optional[int] = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kill_at is None and self.delay_at is None:
            raise ValueError("FaultPlan with neither kill_at nor delay_at "
                             "injects nothing")
        if self.delay_at is not None and self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


def fault_hook(plan: FaultPlan,
               sleep: Callable[[float], None] = time.sleep):
    """A ``step_hook`` carrying out ``plan``. ``sleep`` is injectable so
    tests count delay faults without spending the wall-clock."""
    def hook(t: int):
        if plan.delay_at is not None and t == plan.delay_at:
            sleep(plan.delay_s)
        if plan.kill_at is not None and t == plan.kill_at:
            raise SimulatedFault(f"injected kill before step {t}")
    return hook
