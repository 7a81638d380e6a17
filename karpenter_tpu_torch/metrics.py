"""Metrics registry: prometheus-style counters/gauges/histograms/summaries.

Equivalent of pkg/metrics + the controller-runtime registry — a dependency-
free in-process metrics surface with the same family model, exportable in
prometheus text format. Controllers register the same families the reference
exposes (scheduling duration, consolidation actions, termination summary,
pod/provisioner/node gauges, cloud-provider method durations).
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from .analysis.guards import guarded_by

NAMESPACE = "karpenter"

DURATION_BUCKETS = [0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0]


class Metric:
    def __init__(self, name: str, help: str, label_names: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._lock = threading.Lock()


@guarded_by("_lock", "_values")
class Counter(Metric):
    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, tuple(label_names))
        self._values: Dict[tuple, float] = defaultdict(float)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] += amount

    def value(self, **labels) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def values(self) -> Dict[tuple, float]:
        """Label tuple -> value snapshot (read surfaces like /debug/slo)."""
        with self._lock:
            return dict(self._values)

    def clear(self) -> None:
        """Drop every series. Not a production verb (counters are
        monotonic); per-run harnesses (scenario campaigns) reset between
        runs so each run scores only its own observations."""
        with self._lock:
            self._values.clear()

    def collect(self):
        with self._lock:
            for key, value in self._values.items():
                yield dict(zip(self.label_names, key)), value, ""


@guarded_by("_lock", "_values")
class Gauge(Counter):
    def set(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = value

    def delete(self, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values.pop(key, None)


@guarded_by("_lock", "_counts", "_sums", "_totals")
class Histogram(Metric):
    def __init__(self, name, help, label_names=(), buckets=None):
        super().__init__(name, help, tuple(label_names))
        self.buckets = list(buckets or DURATION_BUCKETS)
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = defaultdict(float)
        self._totals: Dict[tuple, int] = defaultdict(int)

    def observe(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def count(self, **labels) -> int:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._totals.get(key, 0)

    def sum(self, **labels) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._sums.get(key, 0.0)

    def clear(self) -> None:
        """Drop every series (per-run harness reset; see Counter.clear)."""
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()

    def collect(self):
        with self._lock:
            for key in self._totals:
                labels = dict(zip(self.label_names, key))
                counts = self._counts.get(key, [0] * len(self.buckets))
                for bound, cumulative in zip(self.buckets, counts):
                    yield {**labels, "le": repr(bound)}, cumulative, "_bucket"
                yield {**labels, "le": "+Inf"}, self._totals[key], "_bucket"
                yield labels, self._totals[key], "_count"
                yield labels, self._sums[key], "_sum"

    def time(self, **labels):
        return _Timer(self, labels)


@guarded_by("_lock", "_counts", "_sums", "_totals", "_samples")
class Summary(Histogram):
    """Quantile summary approximated from retained samples (bounded)."""

    MAX_SAMPLES = 1024

    def __init__(self, name, help, label_names=(), objectives=(0.5, 0.9, 0.99)):
        super().__init__(name, help, label_names)
        self.objectives = objectives
        self._samples: Dict[tuple, List[float]] = defaultdict(list)

    def observe(self, value: float, **labels) -> None:
        super().observe(value, **labels)
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            samples = self._samples[key]
            samples.append(value)
            if len(samples) > self.MAX_SAMPLES:
                del samples[: len(samples) // 2]

    def series(self) -> List[Dict[str, str]]:
        """One label dict per live series (snapshot surfaces enumerate the
        per-provisioner quantiles without knowing the label values)."""
        with self._lock:
            return [dict(zip(self.label_names, key)) for key in self._totals]

    def clear(self) -> None:
        super().clear()
        with self._lock:
            self._samples.clear()

    def quantile(self, q: float, **labels) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            samples = sorted(self._samples.get(key, []))
        if not samples:
            return math.nan
        return samples[min(len(samples) - 1, int(q * len(samples)))]

    def observations(self, **labels) -> List[float]:
        """The retained raw observations, in arrival order (bounded by
        MAX_SAMPLES with oldest-half eviction) — the windowed-quantile
        surface campaign flatness scores read."""
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return list(self._samples.get(key, ()))

    def collect(self):
        with self._lock:
            keys = list(self._totals)
        for key in keys:
            labels = dict(zip(self.label_names, key))
            for q in self.objectives:
                value = self.quantile(q, **labels)
                if not math.isnan(value):
                    yield {**labels, "quantile": str(q)}, value, ""
            with self._lock:
                # .get, not []: clear() may race this snapshot (a campaign
                # reset between scenarios during a concurrent /metrics
                # scrape) — a vanished key must not kill the exposition
                yield labels, self._totals.get(key, 0), "_count"
                yield labels, self._sums.get(key, 0.0), "_sum"


class _Timer:
    def __init__(self, histogram: Histogram, labels: dict):
        self.histogram = histogram
        self.labels = labels

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.histogram.observe(time.perf_counter() - self._start, **self.labels)
        return False


_KINDS = {Counter: "counter", Gauge: "gauge", Histogram: "histogram", Summary: "summary"}


def escape_help(text: str) -> str:
    """Prometheus exposition escaping for HELP lines: backslash and newline
    (exposition_formats.md); quotes are legal in help text unescaped."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value) -> str:
    """Label-value escaping: backslash, double-quote, newline — unescaped,
    any of these corrupts the whole scrape, not just one series."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


@guarded_by("_lock", "_metrics")
class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help="", label_names=()) -> Counter:
        return self._register(Counter(name, help, label_names))  # type: ignore[return-value]

    def gauge(self, name, help="", label_names=()) -> Gauge:
        return self._register(Gauge(name, help, label_names))  # type: ignore[return-value]

    def histogram(self, name, help="", label_names=(), buckets=None) -> Histogram:
        return self._register(Histogram(name, help, label_names, buckets))  # type: ignore[return-value]

    def summary(self, name, help="", label_names=(), objectives=None) -> Summary:
        if objectives is None:
            return self._register(Summary(name, help, label_names))  # type: ignore[return-value]
        return self._register(Summary(name, help, label_names, objectives))  # type: ignore[return-value]

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def families(self):
        """(name, kind, label_names, help) for every registered family —
        the docgen surface; _KINDS is the one class-to-kind mapping."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return [(m.name, _KINDS.get(type(m), "untyped"), tuple(m.label_names), m.help) for m in metrics]

    def export_text(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            lines.append(f"# HELP {metric.name} {escape_help(metric.help)}")
            lines.append(f"# TYPE {metric.name} {_KINDS.get(type(metric), 'untyped')}")
            for labels, value, suffix in metric.collect():  # type: ignore[attr-defined]
                label_str = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels.items() if v != "")
                label_part = f"{{{label_str}}}" if label_str else ""
                lines.append(f"{metric.name}{suffix}{label_part} {value}")
        return "\n".join(lines) + "\n"


# the default process-wide registry (controller-runtime analog)
REGISTRY = Registry()
