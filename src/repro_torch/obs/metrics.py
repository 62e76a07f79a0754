"""Metrics registry: labelled counters/gauges/histograms with
Prometheus text exposition and JSON export (the port's copy of the
reference's ``obs/metrics.py``, every public name kept).

Pure stdlib, no client library.  The registry is the one funnel every
host-side reading publishes through: ``ServingEngine`` stats and
fragmentation gauges, drained ctl telemetry words (obs/telemetry.py),
and ``StepMonitor`` step-time readings (ft/runtime.py).
``launch/serve.py --metrics-file`` writes the exposition periodically;
``launch/obs_dump.py --metrics`` validates and summarizes it.

Counters here mirror monotonic device words, so they support both
``inc()`` (host-observed events) and ``set()`` (re-publishing an
absolute device total; the Prometheus value is a total either way).
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default latency buckets (milliseconds), as the reference's: from a
# decode tick's few ms to a first tick that builds the kernels.
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def _fmt(v) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class Metric:
    """One metric family; per-label-set samples live in ``samples``."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name, self.help, self.kind = name, help, kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self.samples: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kw) -> "_Sample":
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(kw)}, declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kw[ln]) for ln in self.labelnames)
        return _Sample(self, key)

    # label-less shorthands
    def inc(self, v: float = 1) -> None:
        self.labels().inc(v)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)


class _Sample:
    __slots__ = ("metric", "key")

    def __init__(self, metric: Metric, key: Tuple[str, ...]):
        self.metric, self.key = metric, key

    def inc(self, v: float = 1) -> None:
        if self.metric.kind == "histogram":
            raise TypeError(f"{self.metric.name} is a histogram")
        self.metric.samples[self.key] = \
            self.metric.samples.get(self.key, 0) + v

    def set(self, v: float) -> None:
        if self.metric.kind == "histogram":
            raise TypeError(f"{self.metric.name} is a histogram")
        self.metric.samples[self.key] = v

    def observe(self, v: float) -> None:
        if self.metric.kind != "histogram":
            raise TypeError(f"{self.metric.name} is not a histogram")
        h = self.metric.samples.get(self.key)
        if h is None:
            h = self.metric.samples[self.key] = _Hist(self.metric.buckets)
        h.observe(v)


class MetricsRegistry:
    """A set of metric families, exportable as Prometheus text or JSON."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _declare(self, name, help, kind, labelnames, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-declared with a different "
                    f"kind/label set")
            return m
        m = Metric(name, help, kind, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Metric:
        return self._declare(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Metric:
        return self._declare(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Metric:
        return self._declare(name, help, "histogram", labelnames,
                             buckets=buckets)

    def __iter__(self) -> Iterable[Metric]:
        return iter(self._metrics.values())

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    # ---- exposition -------------------------------------------------------

    @staticmethod
    def _labelstr(names, values, extra=()) -> str:
        pairs = [f'{n}="{v}"' for n, v in zip(names, values)]
        pairs += [f'{n}="{v}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out = []
        for m in self._metrics.values():
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key in sorted(m.samples):
                val = m.samples[key]
                if m.kind == "histogram":
                    acc = 0
                    for b, c in zip(list(val.buckets) + [math.inf],
                                    val.counts):
                        acc += c
                        ls = self._labelstr(m.labelnames, key,
                                            [("le", _fmt(b))])
                        out.append(f"{m.name}_bucket{ls} {acc}")
                    ls = self._labelstr(m.labelnames, key)
                    out.append(f"{m.name}_sum{ls} {_fmt(val.sum)}")
                    out.append(f"{m.name}_count{ls} {val.count}")
                else:
                    ls = self._labelstr(m.labelnames, key)
                    out.append(f"{m.name}{ls} {_fmt(val)}")
        return "\n".join(out) + "\n"

    def to_json(self) -> dict:
        doc = {}
        for m in self._metrics.values():
            samples = []
            for key in sorted(m.samples):
                val = m.samples[key]
                entry = {"labels": dict(zip(m.labelnames, key))}
                if m.kind == "histogram":
                    entry.update(sum=val.sum, count=val.count,
                                 buckets=dict(zip(
                                     [_fmt(b) for b in val.buckets],
                                     val.counts[:-1])),
                                 inf=val.counts[-1])
                else:
                    entry["value"] = val
                samples.append(entry)
            doc[m.name] = {"type": m.kind, "help": m.help,
                           "samples": samples}
        return doc

    def write(self, path: str, fmt: str = "prometheus") -> None:
        with open(path, "w") as f:
            if fmt == "json":
                json.dump(self.to_json(), f, indent=2, sort_keys=True)
                f.write("\n")
            else:
                f.write(self.to_prometheus())


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"                 # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""      # first label
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?" # more labels
    r" (-?[0-9.e+]+|\+Inf|NaN)$")


def validate_exposition(text: str) -> int:
    """Schema check for Prometheus text exposition: every line is a
    HELP/TYPE comment or a well-formed sample, every sample's family was
    TYPE-declared first.  Returns the sample count; raises
    ``ValueError`` on the first bad line."""
    declared = {}
    samples = 0
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {i}: malformed comment {line!r}")
            if parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                    raise ValueError(f"line {i}: bad type {parts[3]!r}")
                declared[parts[2]] = parts[3]
            continue
        if not _SAMPLE_RE.match(line):
            raise ValueError(f"line {i}: malformed sample {line!r}")
        fam = re.split(r"[{ ]", line, 1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", fam)
        if fam not in declared and base not in declared:
            raise ValueError(f"line {i}: sample {fam!r} has no TYPE")
        samples += 1
    if samples == 0:
        raise ValueError("exposition has no samples")
    return samples
