"""Streaming export for repro_torch.obs (counterpart of
``repro.obs.export``, copied): incremental JSONL telemetry while a
run is still going, plus OpenMetrics text exposition of a metrics
registry.

``Session.snapshot()`` is an end-of-session artifact — useless when the
question is "is the 40-minute adversary search making progress or
wedged?".  :class:`ObsStreamer` appends one JSON object per event to a
file and flushes every write, so ``tail -f telemetry.jsonl`` answers
that live.  Open one through the session::

    with obs.session(mode="metrics", stream="telemetry.jsonl"):
        sim.saturation_sweep(g, "tornado", routing="ugal")   # probes stream
        obs.emit("checkpoint", phase="done")                 # ad-hoc events

``obs.emit(kind, **fields)`` is the instrumentation verb: no-op without
a streaming session (same one-global-read discipline as ``obs.span``).
The pre-wired emitters: ``saturation_sweep`` streams one event per
probe, ``adversary.worst_case`` and ``faults.degradation_sweep`` stream
:class:`Progress` done/total/ETA records.

:func:`openmetrics_text` renders a registry (or a snapshot dict) in the
OpenMetrics text format — dots to underscores, ``[variant]`` to a
``variant`` label, counters suffixed ``_total``, histograms as
summaries with quantile labels — so a Prometheus-family scraper can
ingest BENCH telemetry without any new dependency.
"""

from __future__ import annotations

import json
import re
import time

__all__ = ["ObsStreamer", "Progress", "openmetrics_text",
           "write_openmetrics"]

STREAM_SCHEMA = "repro.obs/stream/1"


class ObsStreamer:
    """Append-only JSONL event stream.  The first line is a header with
    the schema tag and the unix start time; every subsequent line is one
    event ``{"kind": ..., "t_s": <seconds since header>, ...fields}``.
    Writes flush immediately (the point is tailing a live file).
    Thread-safe via the file object's own lock + single ``write`` call
    per event."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w")
        self._t0 = time.monotonic()
        self._fh.write(json.dumps({"schema": STREAM_SCHEMA,
                                   "t0_unix": time.time()}) + "\n")
        self._fh.flush()
        self.events = 0

    def emit(self, kind: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"kind": kind, "t_s": round(time.monotonic() - self._t0, 6)}
        for k, v in fields.items():
            if isinstance(v, (str, int, bool)) or v is None:
                rec[k] = v
            else:
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    rec[k] = str(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self.events += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "ObsStreamer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Progress:
    """Done/total/ETA emitter for a counted loop.

    ``step()`` emits a ``progress`` event (label, done, total, pct,
    rate per second, eta_s) through :func:`repro_torch.obs.emit` — free when
    no streaming session is active — and mirrors done/eta into gauges
    (``<label>.done`` / ``<label>.eta_s``) when a session records
    metrics.  ``every`` throttles emission to at most one event per
    that many seconds (0 = every step; loop iterations at probe/trial
    granularity are coarse enough to stream unthrottled)."""

    def __init__(self, label: str, total: int | None = None,
                 every: float = 0.0):
        self.label = label
        self.total = None if total is None else int(total)
        self.every = float(every)
        self.done = 0
        self._t0 = time.monotonic()
        self._last_emit = -1e30

    def step(self, n: int = 1, **fields) -> None:
        self.done += int(n)
        now = time.monotonic()
        if now - self._last_emit < self.every:
            return
        self._last_emit = now
        elapsed = now - self._t0
        rate = self.done / elapsed if elapsed > 0 else 0.0
        rec = {"label": self.label, "done": self.done,
               "elapsed_s": round(elapsed, 3),
               "rate": round(rate, 4)}
        if self.total is not None:
            rec["total"] = self.total
            rec["pct"] = round(100.0 * self.done / max(self.total, 1), 2)
            if rate > 0 and self.done < self.total:
                rec["eta_s"] = round((self.total - self.done) / rate, 1)
        from . import current, emit
        emit("progress", **rec, **fields)
        s = current()
        if s is not None and s.enabled:
            s.metrics.gauge(f"{self.label}.done").set(float(self.done))
            if "eta_s" in rec:
                s.metrics.gauge(f"{self.label}.eta_s").set(rec["eta_s"])


# -- OpenMetrics text exposition ------------------------------------------

_VARIANT = re.compile(r"\[([^\]]*)\]")


def _om_name(name: str) -> tuple[str, str | None]:
    """``sim.backend[fused]`` -> (``repro_sim_backend``, ``fused``)."""
    variant = None
    m = _VARIANT.search(name)
    if m:
        variant = m.group(1)
        name = name[:m.start()] + name[m.end():]
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name.replace(".", "_"))
    return "repro_" + name.strip("_"), variant


def _om_value(v: float) -> str:
    return repr(float(v))


def openmetrics_text(metrics) -> str:
    """Render a metrics collection as OpenMetrics text.

    ``metrics`` is a :class:`MetricsRegistry`, a :class:`Session`, or a
    snapshot dict (``name -> {"type": ..., ...}`` — the ``"metrics"``
    block of ``Session.snapshot()``).  Counters export as ``_total``
    with ``# TYPE counter``; gauges as gauges; histograms and series as
    summaries (quantile labels + ``_count``/``_sum``).  Ends with the
    mandatory ``# EOF``."""
    snap = getattr(metrics, "metrics", metrics)   # Session -> registry
    if hasattr(snap, "snapshot"):                 # registry -> dict
        snap = snap.snapshot()
    if snap is None:
        snap = {}
    lines: list[str] = []
    for name in sorted(snap):
        rec = snap[name]
        om, variant = _om_name(name)
        label = f'{{variant="{variant}"}}' if variant is not None else ""
        kind = rec.get("type")
        if kind == "counter":
            lines.append(f"# TYPE {om} counter")
            lines.append(f"{om}_total{label} {_om_value(rec['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {om} gauge")
            lines.append(f"{om}{label} {_om_value(rec['value'])}")
        elif kind in ("histogram", "series"):
            lines.append(f"# TYPE {om} summary")
            count = int(rec.get("count", 0))
            mean = rec.get("mean", 0.0) if count else 0.0
            for q in ("p50", "p90", "p99"):
                if q in rec:
                    qv = {"p50": "0.5", "p90": "0.9", "p99": "0.99"}[q]
                    if variant is not None:
                        ql = f'{{variant="{variant}",quantile="{qv}"}}'
                    else:
                        ql = f'{{quantile="{qv}"}}'
                    lines.append(f"{om}{ql} {_om_value(rec[q])}")
            lines.append(f"{om}_count{label} {count}")
            lines.append(f"{om}_sum{label} {_om_value(mean * count)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_openmetrics(path: str, metrics) -> None:
    with open(path, "w") as fh:
        fh.write(openmetrics_text(metrics))
