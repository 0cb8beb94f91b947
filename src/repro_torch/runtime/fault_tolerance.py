"""Fault tolerance primitives for long-running jobs (port of
``repro.runtime.fault_tolerance``).

* ``PreemptionGuard`` — installs SIGTERM/SIGINT handlers; the trainer polls
  ``should_stop`` at step boundaries and takes a final checkpoint before
  exiting (the standard preemptible-VM / maintenance-event protocol).
* ``StepWatchdog``  — straggler detection: tracks a robust moving median of
  step times; steps slower than ``threshold ×`` median raise a callback
  (log + counter here; on a real fleet this feeds the rescheduler).
* ``retry_step``    — bounded retry with exponential backoff for transient
  step failures (the serving engine retries injected decode faults
  through it).
"""
from __future__ import annotations

import logging
import random
import signal
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger("repro_torch.runtime")


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; draining", signum)
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop


@dataclass
class StepWatchdog:
    threshold: float = 3.0          # x median
    window: int = 32
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    times: list = field(default_factory=list)
    stragglers: int = 0

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if it was a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if seconds > self.threshold * med:
                self.stragglers += 1
                is_straggler = True
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, seconds, med)
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
        self.times.append(seconds)
        if len(self.times) > 4 * self.window:
            del self.times[:self.window]
        return is_straggler


def retry_step(fn: Callable, *args, retries: int = 2, backoff: float = 0.1,
               retry_on=(RuntimeError,), jitter: float = 0.0,
               seed: int = 0, max_elapsed: float | None = None,
               _sleep: Callable[[float], None] = time.sleep,
               _clock: Callable[[], float] = time.monotonic, **kwargs):
    """Run fn with bounded retry; re-raises after ``retries`` failures.

    Backoff before retry ``attempt`` (0-indexed) is ``backoff * 2**attempt``
    scaled by a *deterministic* jitter factor in ``[1, 1 + jitter]`` drawn
    from ``random.Random(seed)`` — thundering-herd decorrelation without
    giving up reproducible runs (two calls with the same seed sleep the
    same schedule).  ``max_elapsed`` caps the total time budget: once the
    elapsed time plus the next sleep would exceed it, the last failure is
    re-raised immediately even if retry attempts remain.  ``_sleep`` /
    ``_clock`` are injectable for tests.
    """
    rng = random.Random(seed)
    t0 = _clock()
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == retries:
                raise
            delay = backoff * (2 ** attempt)
            if jitter:
                delay *= 1.0 + jitter * rng.random()
            if (max_elapsed is not None
                    and (_clock() - t0) + delay > max_elapsed):
                log.warning("step failed (%s); retry budget %.3fs exhausted "
                            "after %d attempts", e, max_elapsed, attempt + 1)
                raise
            log.warning("step failed (%s); retry %d/%d in %.3fs", e,
                        attempt + 1, retries, delay)
            _sleep(delay)
