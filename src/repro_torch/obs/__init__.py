"""repro_torch.obs — tracing, metrics and telemetry for the port.

Counterpart of ``repro.obs``, with the same public API, metric names and
schema tags (``repro.obs/1``, ``repro.obs/recorder/1``,
``repro.obs/postmortem/1``, ``repro.obs/stream/1``), so the files either
package writes load in either ``report``.  Three faces:

* **tracing** — ``with obs.span("sim.sweep", pattern=...):`` records
  nestable wall-time spans into the active session, exported as
  Chrome-trace/Perfetto JSON (``Session.write_chrome``) or JSONL
  (``write_jsonl``).  The port's seams are instrumented as the
  reference's: arc-load engine dispatch, routing sweeps and blend
  probes, ``saturation_sweep`` probes, placement ``greedy_swap``, fault
  surgery, the simulator's backend and step-build dispatch, and the
  ``train.step`` / ``serve.run`` timings.
* **metrics** — ``obs.counter("sim.delivered").add(x)`` etc. against the
  session's :class:`MetricsRegistry`; the simulator publishes its
  conservation counters (bit-exact with ``SimRun``'s own accounting)
  and the per-link utilization balance statistics
  (:func:`balance_stats`).
* **export** — ``Session.snapshot()`` in the reference's JSON schema,
  live JSONL (:class:`ObsStreamer`, :func:`emit`, :class:`Progress`),
  OpenMetrics text, and the single-file HTML report
  (``python -m repro_torch.obs.report``).

Everything is off by default: with no active session every helper
returns a shared no-op singleton (one module-global read per call — no
allocation, no branches in the caller, no device work).  A session
opened with no mode takes the ``obs`` perf flag (``REPRO_PERF=obs=none|
metrics|trace``, :mod:`repro_torch.perf`; ``none`` by default), or the
caller names one:

    from repro_torch import obs
    with obs.session(mode="trace") as sess:
        sweep = sim.saturation_sweep(g, "tornado", routing="ugal")
        sess.write_chrome("trace.json")
        print(sess.top_spans())

``obs.timed(name)`` is the exception to "off means free": it always
measures (and only *records* under tracing), and its ``sync()`` hook
waits for the card's queued work on the registered CUDA tensors before
closing — the way to time asynchronously launched device work (used by
``repro_torch.train.trainer`` and ``repro_torch.launch.serve``).
"""

from __future__ import annotations

from contextlib import contextmanager

from .export import ObsStreamer, Progress, openmetrics_text, write_openmetrics
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, Series,
                      balance_stats)
from .recorder import FlightRecorder
from .trace import NULL_SESSION, NULL_SPAN, Session, Span
from .watchdog import (Watchdog, WatchdogFired, dest_stability, load_bundle,
                       nonfinite, oscillation, residual, step_time)

__all__ = [
    "Session", "Span", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "Series", "balance_stats", "session", "current", "span", "timed",
    "counter", "gauge", "histogram", "series", "NULL_SPAN", "NULL_SESSION",
    "NULL_METRIC", "FlightRecorder", "Watchdog", "WatchdogFired",
    "residual", "nonfinite", "dest_stability", "step_time", "oscillation",
    "load_bundle", "ObsStreamer", "Progress", "openmetrics_text",
    "write_openmetrics", "emit", "recorder", "watchdog",
]

# innermost active session last; module-global so the fast path is one
# attribute load + truth test
_STACK: list = []


def current():
    """The innermost active :class:`Session`, or None."""
    return _STACK[-1] if _STACK else None


@contextmanager
def session(mode: str | None = None, registry: MetricsRegistry | None = None,
            series: bool | None = None, recorder=None, watchdog=None,
            stream=None):
    """Enter an observability session.  ``mode`` is ``metrics`` or
    ``trace``; None resolves from the ``obs`` perf flag
    (``REPRO_PERF=obs=none|metrics|trace``); ``none`` yields the inert
    :data:`NULL_SESSION` without installing anything.  ``series`` forces
    per-step series capture on/off (default: on only under ``trace``).

    ``recorder`` arms a :class:`FlightRecorder` ring buffer,
    ``watchdog`` a :class:`Watchdog` (bound to this session so its
    postmortem bundles snapshot the recorder/spans/metrics), and
    ``stream`` opens live JSONL telemetry (an :class:`ObsStreamer` or a
    path string — a string is owned and closed on session exit).  The
    session leaves the stack on exit however the block ends."""
    if mode is None:
        from ..perf import flags
        mode = flags().obs
    if mode in (None, "", "none", "off", False, 0):
        yield NULL_SESSION
        return
    s = Session(mode, registry, series=series, recorder=recorder,
                watchdog=watchdog, stream=stream)
    _STACK.append(s)
    try:
        yield s
    finally:
        _STACK.remove(s)
        s.close()


class _NullMetric:
    """Accepts every metric verb, does nothing; handed out when no
    session is active so call sites never branch."""

    __slots__ = ()
    value = 0.0
    values: list = []

    def add(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass

    def append(self, v: float) -> None:
        pass


NULL_METRIC = _NullMetric()


def span(name: str, **attrs):
    """A tracing span: real when the active session traces, the shared
    :data:`NULL_SPAN` singleton otherwise (the no-op fast path)."""
    s = _STACK[-1] if _STACK else None
    if s is None or s.mode != "trace":
        return NULL_SPAN
    return Span(name, attrs, s)


def timed(name: str, **attrs) -> Span:
    """A span that ALWAYS measures (``.seconds`` valid with obs off) and
    records only under tracing.  ``.sync(*objs)`` defers the end
    timestamp until the card has finished the registered CUDA tensors'
    work — use this to time asynchronously launched device work."""
    s = _STACK[-1] if _STACK else None
    return Span(name, attrs, s if (s is not None and s.mode == "trace")
                else None)


def counter(name: str):
    s = _STACK[-1] if _STACK else None
    return NULL_METRIC if s is None else s.metrics.counter(name)


def gauge(name: str):
    s = _STACK[-1] if _STACK else None
    return NULL_METRIC if s is None else s.metrics.gauge(name)


def histogram(name: str):
    s = _STACK[-1] if _STACK else None
    return NULL_METRIC if s is None else s.metrics.histogram(name)


def series(name: str):
    s = _STACK[-1] if _STACK else None
    return NULL_METRIC if s is None else s.metrics.series(name)


def recorder():
    """The active session's :class:`FlightRecorder`, or None — same
    one-global-read fast path as :func:`span` when obs is off."""
    s = _STACK[-1] if _STACK else None
    return None if s is None else s.recorder


def watchdog():
    """The active session's :class:`Watchdog`, or None."""
    s = _STACK[-1] if _STACK else None
    return None if s is None else s.watchdog


def emit(kind: str, **fields) -> None:
    """Stream one telemetry event through the active session's
    :class:`ObsStreamer` — a no-op (one global read, no allocation)
    without a streaming session.  The live-progress verb behind
    :class:`Progress` and the sweep/adversary/faults emitters."""
    s = _STACK[-1] if _STACK else None
    if s is None:
        return
    st = s.stream
    if st is not None:
        st.emit(kind, **fields)
