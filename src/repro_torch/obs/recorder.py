"""Flight recorder for repro_torch.obs: a bounded ring buffer of per-step
channels that survives until something goes wrong.

Counterpart of ``repro.obs.recorder``, copied.  The simulator's series
capture (``_SimCapture``) keeps *whole* per-step curves — fine for a
400-step probe, wrong for runs of minutes to hours, where the
interesting steps are the last few hundred before a collapse and
everything earlier is noise.  :class:`FlightRecorder` keeps exactly the last ``window`` steps
of a fixed channel set in preallocated float64 ring arrays: appending is
one modulo index + one row write, so a recorder armed for a million-step
run costs the same per step as for a thousand-step one and never grows.

Channels are fixed by the FIRST :meth:`record` call (the simulator's
step monitor records the ``SimRun.history`` keys — delivered / accepted
/ offered in per-segment normalized units, occupancy / src_backlog /
diverted raw — plus compact state digests: per-VC occupancy sums and
the running conservation residual).  Because the per-step values are
recorded as the SAME float64 divisions the run's own history arrays
perform, a reloaded bundle window compares bit-exactly against
``SimRun.history`` (pinned in tests/test_torch_recorder_watchdog.py:
Python's ``json`` round-trips float64 via the shortest-repr rule
exactly).

Arm one via the session::

    with obs.session(mode="metrics", recorder=obs.FlightRecorder(256)) as s:
        run = sim.simulate(g, "tornado", routing="ugal_threshold(0)", ...)
    win = s.recorder.window_arrays()   # {"step": ..., "delivered": ..., ...}

The watchdog (:mod:`repro_torch.obs.watchdog`) snapshots the recorder into
every postmortem bundle — the flight recorder is the forensic payload,
the watchdog decides when to dump it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring buffer of per-step channel values.

    ``window`` is the number of trailing steps retained.  The channel
    set is fixed by the first :meth:`record` call; later calls must pass
    the same keys (missing keys raise — a silent NaN would corrupt the
    bit-exactness contract the postmortem tests rely on).
    """

    __slots__ = ("window", "count", "_names", "_buf", "_steps")

    def __init__(self, window: int = 256):
        window = int(window)
        if window < 1:
            raise ValueError(f"recorder window must be >= 1, got {window}")
        self.window = window
        self.count = 0          # total record() calls (steps seen)
        self._names: list[str] | None = None
        self._buf: np.ndarray | None = None     # (window, C) float64
        self._steps: np.ndarray | None = None   # (window,) int64

    @property
    def channels(self) -> list[str]:
        """Channel names, in recorded column order ([] before first use)."""
        return list(self._names) if self._names is not None else []

    def record(self, step: int, values: dict) -> None:
        """Append one step's channel row.  ``values`` maps channel name
        -> float; the first call fixes the channel set and order."""
        if self._names is None:
            self._names = sorted(values)
            self._buf = np.zeros((self.window, len(self._names)),
                                 dtype=np.float64)
            self._steps = np.full(self.window, -1, dtype=np.int64)
        i = self.count % self.window
        buf = self._buf
        for j, name in enumerate(self._names):
            buf[i, j] = values[name]
        self._steps[i] = step
        self.count += 1

    def __len__(self) -> int:
        return min(self.count, self.window)

    def reset(self) -> None:
        """Forget everything, including the channel set."""
        self.count = 0
        self._names = self._buf = self._steps = None

    def _order(self) -> np.ndarray:
        """Row indices of the live window in chronological order."""
        n = len(self)
        if self.count <= self.window:
            return np.arange(n)
        head = self.count % self.window
        return np.concatenate([np.arange(head, self.window),
                               np.arange(0, head)])

    def window_arrays(self) -> dict:
        """The live window, oldest first: ``{"step": int64 array,
        <channel>: float64 array, ...}`` (empty dict before first use).
        Arrays are copies — safe to hold across further recording."""
        if self._names is None:
            return {}
        idx = self._order()
        out = {"step": self._steps[idx].copy()}
        for j, name in enumerate(self._names):
            out[name] = self._buf[idx, j].copy()
        return out

    def snapshot(self) -> dict:
        """JSON-safe export of the live window (the postmortem-bundle
        payload).  Floats serialize via repr, which round-trips float64
        bit-exactly."""
        win = self.window_arrays()
        steps = win.pop("step", None)
        return {"schema": "repro.obs/recorder/1",
                "window": self.window,
                "count": self.count,
                "steps": ([] if steps is None else
                          [int(s) for s in steps]),
                "channels": {name: [float(v) for v in arr]
                             for name, arr in win.items()}}
