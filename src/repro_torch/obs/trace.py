"""Chrome/Perfetto ``trace_event`` spans for serving-engine phases
(the port's copy of the reference's ``obs/trace.py``, every public name
kept).

The engine wraps each phase (admission, prefill, tick, bulk grow,
defrag/rebalance wave, snapshot/restore, eviction, cancel) in a
:meth:`Tracer.span`; the result is a ``{"traceEvents": [...]}`` JSON
document loadable in Perfetto (https://ui.perfetto.dev) or
chrome://tracing.  A tick during which a kernel library was built or
loaded is tagged with category ``"compile"`` instead of ``"steady"``
(the port has no jit: ``ServingEngine.last_tick_compiled``), the same
split ``serve/replay.py`` makes in its latency summary.

Spans time the host.  On the card a kernel launch returns before the
device has run it, so a span measures what the host enqueued and waited
for, not the device work inside it; a span ends at the device only where
its own code reads a result back.  No span adds a synchronisation.

``Tracer(enabled=False)`` (and the module-level :data:`NULL`) is a
no-op with the same surface, so instrumentation sites carry no
conditional logic.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import List

# The span taxonomy (name prefixes the engine emits), the reference's;
# tests validate emitted traces against it.
PHASES = ("admission", "prefill", "tick", "bulk_grow", "defrag_wave",
          "rebalance_wave", "snapshot", "restore", "eviction", "cancel")


class Tracer:
    """Collects complete ("ph": "X") duration events, microsecond
    timestamps from one monotonic origin."""

    def __init__(self, enabled: bool = True, pid: int = 0):
        self.enabled = enabled
        self.pid = pid
        self.events: List[dict] = []
        self._t0 = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    @contextmanager
    def span(self, name: str, cat: str = "engine", **args):
        if not self.enabled:
            yield
            return
        ts = self._now_us()
        try:
            yield
        finally:
            self.events.append({
                "name": name, "cat": cat, "ph": "X", "ts": ts,
                "dur": self._now_us() - ts, "pid": self.pid, "tid": 0,
                "args": args})

    def begin(self) -> float:
        """Timestamp for a deferred :meth:`complete` — for spans whose
        category is only known at close (compile vs steady ticks)."""
        return self._now_us() if self.enabled else 0.0

    def complete(self, name: str, ts: float, cat: str = "engine",
                 **args) -> None:
        """Close a span opened with :meth:`begin`."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "X", "ts": ts,
            "dur": self._now_us() - ts, "pid": self.pid, "tid": 0,
            "args": args})

    def instant(self, name: str, cat: str = "engine", **args) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "ts": self._now_us(),
            "pid": self.pid, "tid": 0, "s": "g", "args": args})

    def to_json(self) -> dict:
        return {"traceEvents": self.events,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
            f.write("\n")


NULL = Tracer(enabled=False)


def validate_trace(doc, require_phases: bool = False) -> int:
    """Schema check for an emitted trace document: a ``traceEvents``
    list whose duration events carry the required Chrome trace-event
    keys, names from the engine taxonomy, and non-negative times.  With
    ``require_phases`` the trace must contain tick spans of BOTH
    categories, compile and steady.  Returns the event count;
    raises ``ValueError`` on the first violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace document (no traceEvents)")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents empty")
    cats_by_name = {}
    for i, ev in enumerate(events):
        for k in ("name", "cat", "ph", "ts", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event {i}: missing {k!r}")
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"event {i}: bad duration")
        if ev["ts"] < 0:
            raise ValueError(f"event {i}: negative timestamp")
        base = ev["name"].split("/")[0]
        if base not in PHASES:
            raise ValueError(
                f"event {i}: name {ev['name']!r} outside the engine "
                f"span taxonomy {PHASES}")
        cats_by_name.setdefault(base, set()).add(ev["cat"])
    if require_phases:
        tick_cats = cats_by_name.get("tick", set())
        if not {"compile", "steady"} <= tick_cats:
            raise ValueError(
                f"trace does not separate compile from steady ticks "
                f"(tick categories seen: {sorted(tick_cats)})")
    return len(events)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
