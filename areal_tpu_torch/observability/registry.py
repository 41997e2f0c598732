"""Process-local metrics registry: counters, gauges, histograms with labels
(copy of ``areal_tpu/observability/registry.py``).

A metric is identified by name; a *series* by (name, label set).  Every
mutation takes a per-metric lock, so worker threads, poll loops and daemon
samplers may write concurrently; ``render()`` emits Prometheus text
exposition format 0.0.4.

Label KEYS must match the canonical table entry when one exists
(:mod:`~areal_tpu_torch.observability.table`), so series cannot fork: a
series whose keys differ from its entry's raises ``ValueError``.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from areal_tpu_torch.observability.table import MetricSpec, table_index

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (seconds), spanning sub-ms host bookkeeping to
#: multi-minute train steps
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _fmt_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in items
    )
    return "{" + body + "}"


class _Metric:
    TYPE = "untyped"

    def __init__(self, name: str, help_: str, spec: Optional[MetricSpec]):
        self.name = name
        self.help = help_
        self._spec = spec
        self._lock = threading.Lock()

    def _label_key(self, labels: Dict[str, str]) -> LabelKey:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r} on {self.name}")
        if self._spec is not None and set(labels) != set(self._spec.labels):
            raise ValueError(
                f"metric {self.name} declares labels "
                f"{sorted(self._spec.labels)} but got {sorted(labels)}"
            )
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def render(self) -> List[str]:
        raise NotImplementedError()

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.TYPE}")
        return lines


class Counter(_Metric):
    TYPE = "counter"

    def __init__(self, name, help_, spec):
        super().__init__(name, help_, spec)
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels: str) -> float:
        key = self._label_key(labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def render(self) -> List[str]:
        lines = self._header()
        with self._lock:
            series = sorted(self._series.items())
        for key, v in series:
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return lines


class Gauge(_Metric):
    TYPE = "gauge"

    def __init__(self, name, help_, spec):
        super().__init__(name, help_, spec)
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str):
        key = self._label_key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str):
        key = self._label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels: str) -> float:
        key = self._label_key(labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def clear(self):
        """Drop every series (snapshot-style gauge families that are fully
        rewritten each step — see :meth:`MetricsRegistry.set_stats`)."""
        with self._lock:
            self._series.clear()

    def render(self) -> List[str]:
        lines = self._header()
        with self._lock:
            series = sorted(self._series.items())
        for key, v in series:
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return lines


class _HistSeries:
    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_, spec, buckets: Sequence[float] = ()):
        super().__init__(name, help_, spec)
        bs = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bs
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels: str):
        key = self._label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            v = float(value)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s.bucket_counts[i] += 1
                    break
            s.sum += v
            s.count += 1

    def snapshot(self, **labels: str) -> Tuple[float, int]:
        """(sum, count) of one series."""
        key = self._label_key(labels)
        with self._lock:
            s = self._series.get(key)
            return (s.sum, s.count) if s else (0.0, 0)

    def render(self) -> List[str]:
        lines = self._header()
        with self._lock:
            series = [
                (key, list(s.bucket_counts), s.sum, s.count)
                for key, s in sorted(self._series.items())
            ]
        for key, counts, total, count in series:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key, [('le', str(b))])} {cum}"
                )
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(key, [('le', '+Inf')])} {count}"
            )
            lines.append(
                f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}"
            )
            lines.append(f"{self.name}_count{_fmt_labels(key)} {count}")
        return lines


class MetricsRegistry:
    """Thread-safe collection of metrics with Prometheus text export."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._table = table_index()

    def _get_or_create(self, cls, name: str, help_: Optional[str], **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name} already registered as {m.TYPE}"
                    )
                return m
            spec = self._table.get(name)
            if help_ is None:
                help_ = spec.help if spec is not None else ""
            m = cls(name, help_, spec, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: Optional[str] = None) -> Counter:
        return self._get_or_create(Counter, name, help_)

    def gauge(self, name: str, help_: Optional[str] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help_)

    def histogram(
        self,
        name: str,
        help_: Optional[str] = None,
        buckets: Sequence[float] = (),
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help_, buckets=buckets)

    def set_stats(self, stats: Dict[str, float]):
        """Fan a ``stats_tracker.export()`` dict into the ``areal_stats``
        gauge family (one series per scoped key).  REPLACES the family:
        a key absent from this step's export disappears from the page
        instead of lingering forever at its last value."""
        g = self.gauge("areal_stats")
        g.clear()
        for k, v in stats.items():
            try:
                g.set(float(v), key=k)
            except (TypeError, ValueError):
                continue

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")


_default_lock = threading.Lock()
_default_registry: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-global registry every in-process instrument writes to
    (one worker per process in production, so per-process == per-worker)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


def set_registry(registry: Optional[MetricsRegistry]) -> None:
    """Swap (or with None, reset) the process-global registry — tests."""
    global _default_registry
    with _default_lock:
        _default_registry = registry
