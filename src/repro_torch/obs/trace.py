"""Span tracing for repro_torch.obs: nestable context managers recording
wall time into an active :class:`Session`, exported as
Chrome-trace/Perfetto JSON (``chrome://tracing`` /
https://ui.perfetto.dev) or a compact JSONL event log.

Counterpart of ``repro.obs.trace``.  Two span flavors share one class:

* ``obs.span(name, **attrs)`` — returns the shared no-op singleton
  unless a tracing session is active: the instrumentation seams all over
  the port cost one global read + one ``is None`` check when obs is off.
* ``obs.timed(name, **attrs)`` — ALWAYS measures (``.seconds`` is valid
  with obs off) and records only when tracing.  ``sync(*objs)``
  registers objects whose device work must finish before the end
  timestamp is taken: the CUDA tensors among them (leaves of dicts,
  lists and tuples), and CUDA ``torch.device`` objects, have their
  devices synchronised, so work the card runs asynchronously is charged
  to the span that launched it.  Where the reference blocks on jax
  values, the port waits on the card; with nothing on a card the sync
  does nothing.

Timestamps are ``perf_counter_ns`` relative to the session start;
``Session.chrome_trace()`` converts to the microsecond ``ts``/``dur``
complete events ("ph": "X") Perfetto renders with nesting inferred per
thread.
"""

from __future__ import annotations

import json
import threading
import time

import torch

from .metrics import MetricsRegistry

__all__ = ["Span", "Session", "NULL_SPAN", "NULL_SESSION"]


class Span:
    """One timed region.  Use as a context manager; ``set(**attrs)``
    annotates mid-flight, ``sync(*objs)`` defers the end timestamp until
    the devices of the registered CUDA tensors (and CUDA devices) have
    finished their queued work."""

    __slots__ = ("name", "attrs", "_session", "_t0_ns", "dur_ns",
                 "_sync_objs", "_depth")

    def __init__(self, name: str, attrs: dict, session: "Session | None"):
        self.name = name
        self.attrs = attrs
        self._session = session
        self._t0_ns = 0
        self.dur_ns = 0
        self._sync_objs = None
        self._depth = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def sync(self, *objs) -> "Span":
        if self._sync_objs is None:
            self._sync_objs = []
        self._sync_objs.extend(objs)
        return self

    @property
    def seconds(self) -> float:
        return self.dur_ns / 1e9

    def __enter__(self) -> "Span":
        s = self._session
        if s is not None:
            tls = s._tls
            self._depth = getattr(tls, "depth", 0)
            tls.depth = self._depth + 1
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sync_objs is not None:
            for dev in _cuda_devices(self._sync_objs, set()):
                torch.cuda.synchronize(dev)
        self.dur_ns = time.perf_counter_ns() - self._t0_ns
        s = self._session
        if s is not None:
            s._tls.depth = self._depth
            s._record(self)
        return False


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors among ``obj``'s leaves (dicts,
    lists and tuples are walked) and of the CUDA ``torch.device``
    objects there; anything else is not waited on."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, torch.device):
        if obj.type == "cuda":
            found.add(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


class _NullSpan:
    """The shared do-nothing span ``obs.span`` hands out when no tracing
    session is active.  A singleton: the overhead-guard test pins that
    repeated ``span()`` calls return this same object."""

    __slots__ = ()
    name = None
    attrs: dict = {}
    dur_ns = 0
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def sync(self, *objs):
        return self


NULL_SPAN = _NullSpan()


class Session:
    """One observability capture: an event list (tracing) + a
    :class:`MetricsRegistry`, both thread-safe.  ``mode`` is ``metrics``
    (counters/gauges/histograms only) or ``trace`` (spans too).  Install
    via :func:`repro_torch.obs.session`; nesting pushes a stack and the
    innermost session receives everything.

    Three optional attachments ride on the session (all None by
    default, so the simulator's hot-loop hooks stay one attribute read
    + ``is None`` test):

    * ``recorder`` — a :class:`repro_torch.obs.FlightRecorder`; the sim's
      step monitor records its per-step channels into the ring buffer.
    * ``watchdog`` — a :class:`repro_torch.obs.Watchdog`; bound to this
      session so its postmortem bundles snapshot the recorder, spans,
      and metrics.
    * ``stream`` — an :class:`repro_torch.obs.ObsStreamer` (or a path string,
      opened and owned by the session): live JSONL telemetry via
      ``obs.emit`` / ``obs.Progress``.
    """

    enabled = True

    def __init__(self, mode: str = "trace",
                 registry: MetricsRegistry | None = None,
                 series: bool | None = None,
                 recorder=None, watchdog=None, stream=None):
        if mode not in ("metrics", "trace"):
            raise ValueError(f"unknown obs mode {mode!r}; "
                             f"options: none, metrics, trace")
        self.mode = mode
        self.metrics = registry if registry is not None else MetricsRegistry()
        # per-step series capture (sim per-VC occupancy, window link-util
        # accumulation, ...) costs host work inside hot loops; default on
        # only under full tracing, overridable either way
        self.series = (mode == "trace") if series is None else bool(series)
        self.recorder = recorder
        self.watchdog = watchdog
        if watchdog is not None:
            watchdog.bind(self)
        self._own_stream = isinstance(stream, str)
        if self._own_stream:
            from .export import ObsStreamer
            stream = ObsStreamer(stream)
        self.stream = stream
        self.events: list = []  # (name, t0_ns, dur_ns, tid, depth, attrs)
        self._t0_ns = time.perf_counter_ns()
        self._wall0 = time.time()
        self._lock = threading.Lock()
        self._tls = threading.local()

    def close(self) -> None:
        """Release owned resources (the stream, when opened from a path
        string); called by ``obs.session`` on exit."""
        if self._own_stream and self.stream is not None:
            self.stream.close()

    @property
    def tracing(self) -> bool:
        return self.mode == "trace"

    def _record(self, span: Span) -> None:
        ev = (span.name, span._t0_ns - self._t0_ns, span.dur_ns,
              threading.get_ident(), span._depth,
              span.attrs if span.attrs else None)
        with self._lock:
            self.events.append(ev)

    # -- summaries ---------------------------------------------------------

    def span_summary(self) -> dict:
        """name -> {count, total_s, max_s} over recorded spans."""
        out: dict = {}
        with self._lock:
            events = list(self.events)
        for name, _t0, dur, _tid, _d, _a in events:
            rec = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                        "max_s": 0.0})
            rec["count"] += 1
            rec["total_s"] += dur / 1e9
            rec["max_s"] = max(rec["max_s"], dur / 1e9)
        for rec in out.values():
            rec["total_s"] = round(rec["total_s"], 6)
            rec["max_s"] = round(rec["max_s"], 6)
        return dict(sorted(out.items()))

    def top_spans(self, k: int = 5) -> list:
        """The k span names with the largest total wall time, as
        ``(name, total_s, count)`` tuples."""
        summ = self.span_summary()
        ranked = sorted(summ.items(), key=lambda kv: -kv[1]["total_s"])
        return [(name, rec["total_s"], rec["count"])
                for name, rec in ranked[:k]]

    def snapshot(self) -> dict:
        """JSON-safe export of everything: the stable schema BENCH files
        embed (schema name pinned in docs/observability.md)."""
        return {"schema": "repro.obs/1", "mode": self.mode,
                "spans": self.span_summary(),
                "metrics": self.metrics.snapshot()}

    # -- trace export ------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome-trace/Perfetto JSON object (complete "X" events,
        microsecond units, nesting inferred per tid)."""
        with self._lock:
            events = list(self.events)
        tids: dict = {}
        trace = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                  "args": {"name": "repro"}}]
        for name, t0, dur, tid, _depth, attrs in events:
            vtid = tids.setdefault(tid, len(tids))
            ev = {"name": name, "cat": name.split(".", 1)[0], "ph": "X",
                  "ts": t0 / 1e3, "dur": dur / 1e3, "pid": 0, "tid": vtid}
            if attrs:
                ev["args"] = _json_safe(attrs)
            trace.append(ev)
        return {"displayTimeUnit": "ms", "traceEvents": trace}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)

    def write_jsonl(self, path: str) -> None:
        """Compact one-event-per-line log; the first line is a header
        with the schema tag and the session's unix start time."""
        with self._lock:
            events = list(self.events)
        with open(path, "w") as fh:
            fh.write(json.dumps({"schema": "repro.obs/1",
                                 "t0_unix": self._wall0,
                                 "mode": self.mode}) + "\n")
            for name, t0, dur, tid, depth, attrs in events:
                rec = {"name": name, "ts_us": round(t0 / 1e3, 3),
                       "dur_us": round(dur / 1e3, 3), "tid": tid,
                       "depth": depth}
                if attrs:
                    rec["attrs"] = _json_safe(attrs)
                fh.write(json.dumps(rec) + "\n")


def _json_safe(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, bool)) or v is None:
            out[k] = v
        else:
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                out[k] = str(v)
    return out


class _NullSession:
    """What ``obs.session()`` yields when the mode resolves to ``none``:
    same surface, nothing recorded, ``snapshot()`` is None (callers use
    that to skip embedding empty obs blocks)."""

    enabled = False
    tracing = False
    series = False
    mode = "none"
    events: list = []
    recorder = None
    watchdog = None
    stream = None

    def snapshot(self):
        return None

    def span_summary(self) -> dict:
        return {}

    def top_spans(self, k: int = 5) -> list:
        return []

    def close(self) -> None:
        pass


NULL_SESSION = _NullSession()
