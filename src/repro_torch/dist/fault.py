"""Fault tolerance for long-running ALS loops (``repro.dist.fault``).

Three pieces, all on the host (nothing here is captured into a CUDA graph):

* :class:`FaultInjector` — deterministic transient-fault injection for
  exercising the recovery paths in tests and the chunk-boundary fault
  surface of ``launch/decompose.py`` (``repro_torch.dist.supervisor``).
  Besides transient faults it can *poison* a step — the supervisor
  corrupts the carried state with NaNs so the numerical-health sentinel's
  rollback path is exercisable.
* :func:`run_with_retries` — retry a step function on
  :class:`TransientFault` with optional exponential backoff + deterministic
  jitter; the caller escalates to checkpoint-restore when retries are
  exhausted (``repro_torch.dist.supervisor``).
* :class:`StepWatchdog` — flags straggler steps whose wall time exceeds a
  multiple of the running median (slow host, contended interconnect, ...).

Pure Python: the port keeps its own copy of the reference's module.
"""
from __future__ import annotations

import random
import statistics
import time
from typing import Callable, Iterable, List, Mapping, Optional, Union

__all__ = ["TransientFault", "FaultInjector", "StepWatchdog", "run_with_retries"]


class TransientFault(RuntimeError):
    """A failure expected to succeed on retry (preempted host, flaky link)."""


def _per_step_counts(steps: Union[Mapping[int, int], Iterable[int]],
                     default: int) -> dict:
    """Normalize ``steps`` to {step: times}: a mapping passes through, a bare
    iterable gets `default` firings per listed step."""
    if isinstance(steps, Mapping):
        return {int(s): int(t) for s, t in steps.items()}
    return {int(s): default for s in steps}


class FaultInjector:
    """Deterministic fault injection at step/chunk boundaries.

    ``fail_steps`` lists steps whose :meth:`check` raises
    :class:`TransientFault` on the first `times` attempts. ``times=1``
    (default) models a transient blip: the in-place retry succeeds.
    ``times > max_retries`` exhausts :func:`run_with_retries`, forcing
    callers through the checkpoint-restore + rewind path — and the fault then
    clears, so the re-run after restore proceeds (a fault that never clears
    would just loop restore forever, which no FT scheme fixes). Either
    argument also accepts a ``{step: times}`` mapping for per-step counts
    (one command line can mix a blip at chunk 1 with an exhausting fault at
    chunk 3 — see ``repro_torch.launch.decompose --fail-at``).

    ``nan_steps`` lists steps to *poison*: :meth:`poison` returns True on
    each listed step's first `times` calls, and the caller corrupts its
    carried state (NaN factors) before dispatching — the supervisor's
    numerical-health sentinel then detects the non-finite fit and rolls back
    to the last good checkpoint.
    """

    def __init__(self, fail_steps: Union[Mapping[int, int], Iterable[int]] = (),
                 *, times: int = 1,
                 nan_steps: Union[Mapping[int, int], Iterable[int]] = ()):
        self._fail_times = _per_step_counts(fail_steps, times)
        self._nan_times = _per_step_counts(nan_steps, 1)
        self.fail_steps = frozenset(self._fail_times)
        self.nan_steps = frozenset(self._nan_times)
        self.times = times
        self._fired: dict = {}
        self._poisoned: dict = {}

    def check(self, step: int) -> None:
        if self._fired.get(step, 0) < self._fail_times.get(step, 0):
            self._fired[step] = self._fired.get(step, 0) + 1
            raise TransientFault(f"injected fault at step {step}")

    def poison(self, step: int) -> bool:
        """True on each listed step's first `times` calls; the caller NaNs
        its state in response (the injector itself never touches arrays)."""
        if self._poisoned.get(step, 0) < self._nan_times.get(step, 0):
            self._poisoned[step] = self._poisoned.get(step, 0) + 1
            return True
        return False


def run_with_retries(fn: Callable, *args, max_retries: int = 3,
                     on_retry: Optional[Callable] = None,
                     backoff: float = 0.0, backoff_factor: float = 2.0,
                     jitter: float = 0.0, seed: int = 0,
                     sleep: Callable = time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying up to `max_retries` times on
    :class:`TransientFault`; the last fault re-raises once retries are
    exhausted. `on_retry(attempt, exc)` runs before each retry.

    ``backoff > 0`` sleeps ``backoff * backoff_factor**attempt`` seconds
    before retry `attempt` (exponential), scaled by ``1 + jitter * u`` with
    ``u ~ U[0, 1)`` drawn from a PRIVATE ``random.Random(seed)`` stream —
    deterministic and seedable, so tests (and bitwise replay comparisons)
    see identical schedules without touching the global RNG. `sleep` is
    injectable for tests.
    """
    rng = random.Random(seed) if jitter > 0.0 else None
    for attempt in range(max_retries + 1):
        try:
            return fn(*args, **kwargs)
        except TransientFault as e:
            if attempt >= max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff > 0.0:
                delay = backoff * (backoff_factor ** attempt)
                if rng is not None:
                    delay *= 1.0 + jitter * rng.random()
                sleep(delay)


class StepWatchdog:
    """Flag steps slower than ``factor`` x the running median step time.

    Flagged durations are excluded from the history so one straggler does not
    drag the baseline up; ``min_history`` observations are required before
    anything is flagged (cold-start compiles are never stragglers).
    """

    def __init__(self, factor: float = 3.0, *, min_history: int = 3,
                 window: int = 50):
        self.factor = factor
        self.min_history = min_history
        self.window = window
        self._times: List[float] = []
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Record one step duration; returns True if `step` is a straggler."""
        hist = self._times[-self.window:]
        slow = (len(hist) >= self.min_history
                and dt > self.factor * statistics.median(hist))
        if slow:
            self.flagged.append(step)
        else:
            self._times.append(dt)
            del self._times[:-self.window]   # bound history for long runs
        return slow
