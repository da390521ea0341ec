"""Anomaly watchdogs for repro_torch.obs (counterpart of
``repro.obs.watchdog``, copied): declarative triggers over the
simulator's per-step sample stream that dump a self-contained postmortem
bundle the moment something breaks — while the flight recorder still
holds the evidence.

The trigger taxonomy (docs/observability.md):

* :func:`residual` — the running flow-conservation identity
  (``|injected − delivered − occupancy − backlog − dropped| /
  injected``) exceeds a tolerance: mass is leaking or appearing, the
  cardinal simulator bug class.
* :func:`nonfinite` — NaN/inf in the step stats or negative fluid mass:
  the numerical smoke alarm (a float32 fused backend gone wrong fires
  this long before the aggregate curves look off).
* :func:`dest_stability` — the minimum per-dest-column
  delivered/offered ratio over a rolling window collapses below a
  floor: the sharp per-column knee criterion, live (this is the trigger
  a past-knee ``ugal_threshold`` probe fires; see the e2e test).
* :func:`step_time` — one step's wall time spikes past a multiple of
  the running mean: a recompile, a swap storm, a wedged device.
* :func:`oscillation` — sweep-level: a probe at HIGHER offered load
  reports stable after a LOWER one collapsed, so the knee bisection is
  chasing a non-monotone stability frontier (fed by
  ``saturation_sweep`` via :meth:`Watchdog.on_probe`).

On firing, the watchdog writes a postmortem bundle
(``repro.obs/postmortem/1``): trigger + reason + step, the run context
(`SimConfig` fields, demand fingerprint, backend, git rev), the flight
recorder's ring-buffer snapshot, and the session's span summary and
metrics snapshot.  ``action="continue"`` (default) keeps the run going
— one bundle per trigger, ``max_bundles`` total — while
``action="halt"`` raises :class:`WatchdogFired` after the dump.

Wire one through the session::

    wd = obs.Watchdog([obs.dest_stability(ratio=0.5)], dir="postmortems")
    with obs.session(mode="metrics", recorder=obs.FlightRecorder(128),
                     watchdog=wd):
        sim.simulate(g, "tornado", routing="ugal_threshold(0)",
                     offered=2.0 * theta)
    assert wd.fired                  # [(trigger_name, bundle_path), ...]
    bundle = obs.load_bundle(wd.fired[0][1])

Triggers declare what per-step inputs they ``need`` ("dest_mass",
"step_seconds") so the simulator's monitor only computes the expensive
digests a trigger actually consumes.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

__all__ = ["Watchdog", "WatchdogFired", "Trigger", "residual", "nonfinite",
           "dest_stability", "step_time", "oscillation", "load_bundle"]

BUNDLE_SCHEMA = "repro.obs/postmortem/1"


class WatchdogFired(RuntimeError):
    """Raised by a halting watchdog after the postmortem bundle is on
    disk.  ``trigger`` / ``reason`` / ``path`` identify what fired."""

    def __init__(self, trigger: str, reason: str, path: str | None):
        super().__init__(f"watchdog trigger {trigger!r} fired: {reason}"
                         + (f" (bundle: {path})" if path else ""))
        self.trigger = trigger
        self.reason = reason
        self.path = path


class Trigger:
    """One anomaly predicate over the per-step sample stream.

    Subclasses set ``name``, declare ``needs`` (tags of expensive
    per-step inputs they consume: "dest_mass", "step_seconds"), and
    implement :meth:`check` returning a human-readable reason string
    when the predicate fires (None otherwise).  A trigger fires at most
    once per run (re-armed by :meth:`reset`)."""

    name = "trigger"
    needs: frozenset = frozenset()

    def __init__(self):
        self.fired = False

    def reset(self) -> None:
        self.fired = False

    def check(self, sample: dict):
        raise NotImplementedError

    def describe(self) -> dict:
        """JSON-safe self-description for the bundle."""
        return {"name": self.name}


class _Residual(Trigger):
    name = "residual"

    def __init__(self, tol: float = 1e-6, warmup: int = 8):
        super().__init__()
        self.tol = float(tol)
        self.warmup = int(warmup)

    def check(self, sample):
        if sample["step"] < self.warmup:
            return None
        r = sample.get("residual")
        if r is not None and r > self.tol:
            return (f"conservation residual {r:.3e} > tol {self.tol:.1e} "
                    f"at step {sample['step']}")
        return None

    def describe(self):
        return {"name": self.name, "tol": self.tol, "warmup": self.warmup}


class _NonFinite(Trigger):
    name = "nonfinite"
    # negative-mass detection wants the per-dest mass digest when a
    # dest_stability trigger already pays for it, but must not force it:
    # the row stats alone catch NaN/inf propagation
    _STAT_KEYS = ("delivered", "accepted", "offered", "occupancy",
                  "src_backlog", "diverted")

    def __init__(self, mass_floor: float = -1e-6):
        super().__init__()
        self.mass_floor = float(mass_floor)

    def check(self, sample):
        for k in self._STAT_KEYS:
            v = sample.get(k)
            if v is not None and not np.isfinite(v):
                return f"non-finite {k}={v!r} at step {sample['step']}"
        for k in ("occupancy", "src_backlog"):
            v = sample.get(k)
            if v is not None and v < self.mass_floor:
                return (f"negative mass {k}={v:.3e} at step "
                        f"{sample['step']}")
        mn = sample.get("dest_mass_min")
        if mn is not None:
            if not np.isfinite(mn):
                return f"non-finite dest mass at step {sample['step']}"
            if mn < self.mass_floor:
                return (f"negative per-dest mass {mn:.3e} at step "
                        f"{sample['step']}")
        return None

    def describe(self):
        return {"name": self.name, "mass_floor": self.mass_floor}


class _DestStability(Trigger):
    """Consumes the ``dest_stability_min`` digest the simulator's step
    monitor computes (rolling per-dest delivered/offered over the
    watchdog's :meth:`Watchdog.stability_window` — the _SimCapture
    mass-bookkeeping identity evaluated live each step instead of once
    at the run's end)."""

    name = "dest_stability"
    needs = frozenset({"dest_mass"})

    def __init__(self, ratio: float = 0.5, window: int = 32,
                 warmup: int = 32):
        super().__init__()
        self.ratio = float(ratio)
        self.window = int(window)
        self.warmup = int(warmup)

    def check(self, sample):
        mn = sample.get("dest_stability_min")
        if mn is None or not np.isfinite(mn):
            return None
        if sample["step"] < self.warmup + self.window:
            return None
        if mn < self.ratio:
            col = sample.get("dest_stability_col")
            where = f" (dest col {col})" if col is not None else ""
            return (f"per-dest stability collapsed: min ratio {mn:.4f} < "
                    f"{self.ratio}{where} over the trailing window at "
                    f"step {sample['step']}")
        return None

    def describe(self):
        return {"name": self.name, "ratio": self.ratio,
                "window": self.window, "warmup": self.warmup}


class _StepTime(Trigger):
    name = "step_time"
    needs = frozenset({"step_seconds"})

    def __init__(self, factor: float = 20.0, warmup: int = 16,
                 floor_s: float = 0.05):
        super().__init__()
        self.factor = float(factor)
        self.warmup = int(warmup)
        self.floor_s = float(floor_s)
        self._sum = 0.0
        self._n = 0

    def reset(self):
        super().reset()
        self._sum = 0.0
        self._n = 0

    def check(self, sample):
        dt = sample.get("step_seconds")
        if dt is None:
            return None
        self._n += 1
        self._sum += dt
        if self._n <= self.warmup:
            return None
        mean = (self._sum - dt) / (self._n - 1)
        if dt > self.floor_s and dt > self.factor * max(mean, 1e-12):
            return (f"step {sample['step']} took {dt:.3f}s, "
                    f"{dt / max(mean, 1e-12):.0f}x the running mean "
                    f"{mean * 1e3:.2f}ms")
        return None

    def describe(self):
        return {"name": self.name, "factor": self.factor,
                "warmup": self.warmup, "floor_s": self.floor_s}


class _Oscillation(Trigger):
    """Sweep-level: fed probe outcomes via Watchdog.on_probe, not
    per-step samples."""

    name = "oscillation"

    def __init__(self):
        super().__init__()
        self._min_unstable = None   # smallest offered load seen to collapse
        self._probes = 0

    def reset(self):
        super().reset()
        self._min_unstable = None
        self._probes = 0

    def check(self, sample):   # not step-driven
        return None

    def on_probe(self, offered: float, stable: bool):
        self._probes += 1
        if not stable:
            if (self._min_unstable is None
                    or offered < self._min_unstable):
                self._min_unstable = offered
            return None
        if (self._min_unstable is not None
                and offered > self._min_unstable * (1 + 1e-12)):
            return (f"knee oscillation: probe at offered={offered:.6g} "
                    f"is stable ABOVE the collapsed probe at "
                    f"offered={self._min_unstable:.6g} "
                    f"(probe #{self._probes}) — the stability frontier "
                    f"is non-monotone")
        return None

    def describe(self):
        return {"name": self.name}


def residual(tol: float = 1e-6, warmup: int = 8) -> Trigger:
    """Fire when the running conservation residual exceeds ``tol``."""
    return _Residual(tol, warmup)


def nonfinite(mass_floor: float = -1e-6) -> Trigger:
    """Fire on NaN/inf step stats or negative fluid mass."""
    return _NonFinite(mass_floor)


def dest_stability(ratio: float = 0.5, window: int = 32,
                   warmup: int = 32) -> Trigger:
    """Fire when the min per-dest delivered/offered ratio over a rolling
    ``window`` drops below ``ratio`` (after ``warmup`` + ``window``
    steps).  Needs the per-dest mass digest — the one trigger that costs
    a host pass over the dest tensors per step."""
    return _DestStability(ratio, window, warmup)


def step_time(factor: float = 20.0, warmup: int = 16,
              floor_s: float = 0.05) -> Trigger:
    """Fire when one step's wall time exceeds ``factor`` times the
    running mean (and ``floor_s`` absolute — sub-50ms spikes are
    scheduler noise, not anomalies)."""
    return _StepTime(factor, warmup, floor_s)


def oscillation() -> Trigger:
    """Fire when a sweep's stability frontier is non-monotone in
    offered load (a stable probe above a collapsed one)."""
    return _Oscillation()


def _git_rev() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except Exception:
        return None


def _json_safe(v):
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, np.ndarray):
        return [_json_safe(x) for x in v.tolist()]
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class Watchdog:
    """A set of anomaly triggers plus the postmortem dump policy.

    ``triggers`` is a list from the factory functions above;
    ``action`` is ``"continue"`` (dump and keep running; default) or
    ``"halt"`` (dump, then raise :class:`WatchdogFired`); ``dir`` is
    where bundles land (created on first dump; None keeps bundles
    in-memory only — ``last_bundle`` holds the dict); ``max_bundles``
    caps total dumps per watchdog so a persistent anomaly cannot spam
    the disk.

    The simulator calls :meth:`begin_run` with the run's context,
    :meth:`on_step` with one sample dict per step, and
    ``saturation_sweep`` calls :meth:`on_probe` per probe.  ``fired``
    accumulates ``(trigger_name, bundle_path)`` tuples."""

    def __init__(self, triggers, action: str = "continue",
                 dir: str | None = "postmortems", max_bundles: int = 4):
        if action not in ("continue", "halt"):
            raise ValueError(f"unknown watchdog action {action!r}; "
                             f"options: continue, halt")
        self.triggers = list(triggers)
        self.action = action
        self.dir = dir
        self.max_bundles = int(max_bundles)
        self.fired: list = []        # (trigger_name, path-or-None)
        self.last_bundle: dict | None = None
        self._session = None
        self._context: dict = {}

    def bind(self, session) -> None:
        """Attach the session whose recorder/spans/metrics the bundle
        snapshots (done by ``Session.__init__``)."""
        self._session = session

    def needs(self, tag: str) -> bool:
        """True when any live trigger consumes the per-step input
        ``tag`` ("dest_mass", "step_seconds") — the monitor skips
        computing digests nothing will read."""
        return any(tag in t.needs and not t.fired for t in self.triggers)

    def stability_window(self) -> int | None:
        """The rolling window (steps) the per-dest stability digest
        should use — the max over armed dest_stability triggers, None
        when none is armed (the monitor then skips the per-step
        dest-mass pass entirely)."""
        wins = [t.window for t in self.triggers
                if isinstance(t, _DestStability) and not t.fired]
        return max(wins) if wins else None

    @property
    def exhausted(self) -> bool:
        return (len(self.fired) >= self.max_bundles
                or all(t.fired for t in self.triggers))

    def begin_run(self, **context) -> None:
        """Install one run's context (config fields, demand fingerprint,
        backend, steps) and re-arm per-run trigger state.  Fired
        triggers stay fired: one bundle per trigger per watchdog."""
        self._context = _json_safe(context)
        for t in self.triggers:
            if not t.fired:
                t.reset()

    def on_step(self, sample: dict) -> None:
        """Evaluate every armed trigger against one step sample; dump
        (and optionally halt) on the first that fires."""
        if self.exhausted:
            return
        for t in self.triggers:
            if t.fired:
                continue
            reason = t.check(sample)
            if reason is not None:
                self._fire(t, reason, sample)

    def on_probe(self, offered: float, stable: bool) -> None:
        """Feed one sweep probe outcome to the oscillation trigger(s)."""
        if self.exhausted:
            return
        for t in self.triggers:
            if t.fired or not isinstance(t, _Oscillation):
                continue
            reason = t.on_probe(float(offered), bool(stable))
            if reason is not None:
                self._fire(t, reason,
                           {"offered": float(offered), "stable": stable})

    def _fire(self, trigger: Trigger, reason: str, sample: dict) -> None:
        trigger.fired = True
        bundle = self._bundle(trigger, reason, sample)
        path = None
        if self.dir is not None and len(self.fired) < self.max_bundles:
            os.makedirs(self.dir, exist_ok=True)
            step = sample.get("step", "probe")
            path = os.path.join(
                self.dir, f"postmortem_{trigger.name}_{step}.json")
            with open(path, "w") as fh:
                json.dump(bundle, fh, indent=1)
        self.last_bundle = bundle
        self.fired.append((trigger.name, path))
        if self.action == "halt":
            raise WatchdogFired(trigger.name, reason, path)

    def _bundle(self, trigger: Trigger, reason: str, sample: dict) -> dict:
        sess = self._session
        rec = getattr(sess, "recorder", None) if sess is not None else None
        # drop the heavy per-dest arrays from the frozen sample; the
        # digest scalars and the recorder window carry the story
        slim = {k: v for k, v in sample.items()
                if k not in ("dest_mass", "off_dest")}
        return {
            "schema": BUNDLE_SCHEMA,
            "trigger": trigger.describe(),
            "reason": reason,
            "sample": _json_safe(slim),
            "context": self._context,
            "git_rev": _git_rev(),
            "t_unix": time.time(),
            "recorder": rec.snapshot() if rec is not None else None,
            "spans": (sess.span_summary()
                      if sess is not None and sess.enabled else {}),
            "metrics": (sess.metrics.snapshot()
                        if sess is not None and sess.enabled else {}),
        }


def load_bundle(path: str) -> dict:
    """Reload a postmortem bundle; validates the schema tag."""
    with open(path) as fh:
        bundle = json.load(fh)
    if bundle.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(f"{path}: not a postmortem bundle "
                         f"(schema={bundle.get('schema')!r})")
    return bundle
