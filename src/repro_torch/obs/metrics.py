"""Metric primitives for repro_torch.obs: counters, gauges, histograms, and
append-only time series behind one pluggable registry.

Counterpart of ``repro.obs.metrics``, copied: plain Python + numpy and
process-local.  A :class:`MetricsRegistry` belongs to one
:class:`repro_torch.obs.Session`, so two concurrent sessions never share
state.  ``snapshot()`` renders the whole registry as JSON-safe dicts in
the reference's schema (docs/observability.md has the metric-name
taxonomy).

``balance_stats`` is the paper-thesis statistic: given a vector of
per-link utilizations (or loads) it reports the Gini coefficient,
p99-over-mean, and max-over-mean — the "how balanced is the fabric"
numbers the projective-network claim is about.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Series", "MetricsRegistry",
           "balance_stats"]


class Counter:
    """Monotone accumulator (``add``); float-valued so fluid mass and
    call counts share one type.

    Mutation takes a per-metric lock: any caller may publish from worker
    threads, and ``self.value += v`` is a read-modify-write that loses
    increments under free-threaded interleaving.  The lock only costs
    when a session is active (obs off hands out NULL_METRIC)."""

    __slots__ = ("name", "value", "_lock")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def add(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": float(self.value)}


class Gauge:
    """Last-write-wins value (``set``)."""

    __slots__ = ("name", "value", "_lock")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.value = v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": float(self.value)}


class Series:
    """Append-only time series (one value per step / iteration).

    ``snapshot()`` exports summary statistics only — per-step values can
    run to thousands of points, and BENCH files must stay diffable;
    callers that want the raw curve read ``.values`` (or
    ``np.asarray(series)``) programmatically.
    """

    __slots__ = ("name", "values", "_lock")
    kind = "series"

    def __init__(self, name: str):
        self.name = name
        self.values: list[float] = []
        self._lock = threading.Lock()

    def append(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.values.append(v)

    def __len__(self) -> int:
        return len(self.values)

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def snapshot(self) -> dict:
        if not self.values:
            return {"type": "series", "count": 0}
        a = np.asarray(self.values, dtype=np.float64)
        return {"type": "series", "count": int(a.size),
                "mean": float(a.mean()), "min": float(a.min()),
                "max": float(a.max()), "last": float(a[-1])}


class Histogram:
    """Value distribution; keeps raw observations (cheap at the volumes
    obs runs at) and summarizes to count/mean/percentiles on export."""

    __slots__ = ("name", "_vals", "_lock")
    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self._vals: list = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._vals.append(v)

    def observe_many(self, values) -> None:
        a = np.asarray(values, dtype=np.float64).ravel()
        with self._lock:
            self._vals.append(a)

    @property
    def values(self) -> np.ndarray:
        with self._lock:
            vals = list(self._vals)
        if not vals:
            return np.empty(0, dtype=np.float64)
        return np.concatenate([np.atleast_1d(np.asarray(v, np.float64))
                               for v in vals])

    def snapshot(self) -> dict:
        a = self.values
        if a.size == 0:
            return {"type": "histogram", "count": 0}
        return {"type": "histogram", "count": int(a.size),
                "mean": float(a.mean()), "min": float(a.min()),
                "max": float(a.max()),
                "p50": float(np.percentile(a, 50)),
                "p90": float(np.percentile(a, 90)),
                "p99": float(np.percentile(a, 99))}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "series": Series}


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.  Re-requesting a
    name with a different kind is an error (the taxonomy is global; see
    docs/observability.md)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str):
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {kind}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _KINDS[kind](name)
                self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._get("histogram", name)

    def series(self, name: str) -> Series:
        return self._get("series", name)

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}


def balance_stats(loads) -> dict:
    """Balance statistics of a nonnegative load/utilization vector: the
    paper's balanced-utilization thesis, measured.

    Returns ``gini`` (0 = perfectly balanced, -> 1 as one link carries
    everything), ``p99_over_mean`` and ``max_over_mean`` (both 1.0 when
    flat; ``max_over_mean`` is ``1/u`` in the paper's utilization
    notation), plus ``mean``/``max``/``n`` for context."""
    x = np.asarray(loads, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    n = int(x.size)
    if n == 0 or float(x.sum()) <= 0.0:
        return {"gini": 0.0, "p99_over_mean": 1.0, "max_over_mean": 1.0,
                "mean": 0.0, "max": 0.0, "n": n}
    xs = np.sort(x)
    i = np.arange(1, n + 1, dtype=np.float64)
    gini = float(2.0 * (i * xs).sum() / (n * xs.sum()) - (n + 1) / n)
    mean = float(x.mean())
    return {"gini": gini,
            "p99_over_mean": float(np.percentile(x, 99) / mean),
            "max_over_mean": float(x.max() / mean),
            "mean": mean, "max": float(x.max()), "n": n}
