"""Fault-tolerance runtime (port of the reference's ``ft/runtime.py``):
preemption and stragglers.

- ``PreemptionGuard``: SIGTERM/SIGINT → finish the current step, force
  a checkpoint, exit clean (``launch/serve.py --snapshot-dir`` snapshots
  the serving state at the tick boundary and exits with code 3).
- ``StepMonitor``: per-step wall-time EWMA and outlier detection; a
  host whose EWMA exceeds ``threshold``× the fleet median is flagged
  for the scheduler to replace.  With a ``registry`` (obs/metrics.py)
  every :meth:`StepMonitor.stop` publishes through it.

The reference's ``elastic_rescale`` re-shards a state onto a new mesh
and comes with the port of its sharding rules.
"""
from __future__ import annotations

import collections
import signal
import time
from typing import Optional

import numpy as np


class PreemptionGuard:
    """SIGTERM-safe loops: the loop asks ``should_stop`` each step."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # not main thread (tests)

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StepMonitor:
    """EWMA step-time tracking + straggler flagging.

    With a ``registry`` (obs/metrics.py), every :meth:`stop` also
    publishes through it — a step-time histogram
    (``repro_step_time_ms``), the EWMA gauge, and a straggler-flag
    counter — so every loop exports through the same funnel."""

    def __init__(self, alpha: float = 0.1, threshold: float = 1.5,
                 warmup: int = 2, registry=None):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.registry = registry
        self.ewma: Optional[float] = None
        self.history = collections.deque(maxlen=512)
        self._count = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        if self._t0 is None:
            raise RuntimeError(
                "StepMonitor.stop() without a matching start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._count += 1
        self.history.append(dt)
        straggler = False
        if self._count > self.warmup:  # skip the warm-up steps
            if self.ewma is None:
                # seed from the warmup history (median — robust to the
                # compile-step outlier), not from this measurement: an
                # EWMA seeded from the step it judges can never flag it
                prior = list(self.history)[:-1]
                self.ewma = float(np.median(prior)) if prior else dt
            straggler = dt > self.threshold * self.ewma
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if self.registry is not None:
            self.registry.histogram(
                "repro_step_time_ms",
                "wall-clock per monitored step").observe(1e3 * dt)
            self.registry.counter(
                "repro_steps_total", "monitored steps").inc()
            if self.ewma is not None:
                self.registry.gauge(
                    "repro_step_time_ewma_ms",
                    "EWMA step time (post-warmup)").set(1e3 * self.ewma)
            if straggler:
                self.registry.counter(
                    "repro_straggler_flags_total",
                    "steps flagged above threshold x EWMA").inc()
        return {"step_time": dt, "ewma": self.ewma,
                "straggler": straggler}

    def fleet_report(self, per_host_times: np.ndarray) -> np.ndarray:
        """Multi-host: flag hosts above threshold × fleet median.
        ``per_host_times``: (hosts,) from the metrics allgather."""
        med = np.median(per_host_times)
        return per_host_times > self.threshold * med
