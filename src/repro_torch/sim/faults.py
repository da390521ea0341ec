"""Mid-run fault events for the flow-level simulator.

The port's counterpart of ``repro.sim.faults``, on the run's device.  A
live fabric does not fail at t = 0: links and routers die (and come
back) while fluid is in flight.  ``Simulator.run(events=...)`` takes a
schedule of :class:`FaultEvent`\\ s; at each event boundary the run
switches to route tables compiled for the event's fault state
(``build_tables(faults=...)``: masked splits are the reroute) and passes
the live state through :func:`apply_fault_surgery`:

  * fluid whose (router, dest) pair is no longer routable is DROPPED and
    accounted (``SimRun.dropped``; the conservation residual includes
    it);
  * fluid queued in a dead out-slot is requeued through the new minimal
    split of its router (conserving);
  * the Valiant pending pool loses its dead (mid, dest) columns, and the
    matching fraction of vc1 / stage2 fluid is dropped with it, so that
    the per-mid invariant ``pend row mass == vc1-toward-mid + stage2``
    survives the surgery;
  * source backlog toward unroutable dests is dropped.

Each event's ``faults`` is the CUMULATIVE fault state from that step on
(not a delta); recovery is a later event with a smaller, or empty,
FaultSet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.faults import FaultSet
from .tables import RouteTables

__all__ = ["FaultEvent", "normalize_events", "apply_fault_surgery"]


@dataclass(frozen=True)
class FaultEvent:
    """``faults`` is the full fault state of the fabric from ``step`` on."""

    step: int
    faults: FaultSet

    def __post_init__(self):
        if int(self.step) != self.step or self.step < 0:
            raise ValueError(f"event step must be a nonnegative int, "
                             f"got {self.step!r}")
        object.__setattr__(self, "step", int(self.step))
        if not isinstance(self.faults, FaultSet):
            raise TypeError(f"event faults must be a FaultSet, "
                            f"got {type(self.faults).__name__}")


def normalize_events(events) -> tuple:
    """Sorted tuple of FaultEvents from an iterable of FaultEvents or
    ``(step, FaultSet)`` pairs; duplicate steps are rejected (each step
    has one fault state)."""
    if events is None:
        return ()
    evs = []
    for e in events:
        if isinstance(e, FaultEvent):
            evs.append(e)
        else:
            step, fs = e
            evs.append(FaultEvent(step=step, faults=fs))
    evs.sort(key=lambda e: e.step)
    steps = [e.step for e in evs]
    if len(set(steps)) != len(steps):
        raise ValueError(f"duplicate fault-event steps in {steps}")
    return tuple(evs)


def apply_fault_surgery(state: tuple, t: RouteTables,
                        dest_cols=None) -> tuple[tuple, float]:
    """Reconcile live fluid state with new route tables ``t``.

    ``state`` is the step tuple ``(q0, q1, q2, src, pend, stage2)`` of
    tensors on the tables' device.  Returns ``(new_state, dropped)``:
    the state in its own dtypes (the surgery itself runs in float64) and
    the total fluid mass removed, which is unroutable queue fluid, source
    backlog toward dead dests and the vc1 / stage2 fraction matched to
    dead pending columns.  Requeue from dead out-slots conserves mass
    (the new split rows sum to 1 on every surviving routable pair).  A
    second pass against the same tables drops nothing.

    With ``dest_cols`` (the fused step's compacted dest axis) q0 / q2 /
    src and the pend pool's dest axis carry only those active columns;
    the routable and split views are column-selected to match."""
    f64 = torch.float64
    dtypes = [a.dtype for a in state]
    q0, q1, q2, src, pend, stage2 = [a.to(f64) for a in state]
    routable = t.routable
    slot_ok = t.slot_ok
    split = t.split.to(f64)
    if dest_cols is None:
        routable_c, split_c = routable, split
        keep_pend = routable[t.active, :]                    # (M, M)
    else:
        cols = torch.as_tensor(np.asarray(dest_cols, dtype=np.int64),
                               device=split.device)
        routable_c = routable[:, cols]                       # (N, C)
        split_c = split[:, :, cols]                          # (N, K, C)
        keep_pend = routable[t.active][:, cols]              # (M, C)
    dropped = torch.zeros((), dtype=f64, device=split.device)

    # 1. pend[mid, dest] survives iff dest is still routable from the
    # mid; vc1 fluid and stage2 credit shrink by the same per-mid
    # fraction, keeping conversion mixing consistent
    row_tot = pend.sum(dim=1)
    pend = pend * keep_pend
    frac = torch.where(row_tot > 0,
                       pend.sum(dim=1) / row_tot.clamp(min=1e-300),
                       torch.ones_like(row_tot))
    before = q1.sum() + stage2.sum()
    q1 = q1 * frac[None, None, :]                            # dest = mid
    stage2 = stage2 * frac
    dropped = dropped + before - (q1.sum() + stage2.sum())

    # 2. unroutable (router, dest) fluid is lost with the fault
    qs = []
    for q, rt in ((q0, routable_c), (q1, routable), (q2, routable_c)):
        before = q.sum()
        q = q * rt[:, None, :]
        dropped = dropped + before - q.sum()
        qs.append(q)

    # 3. fluid in dead out-slots requeues through the new minimal split
    dead = ~slot_ok
    for i, sp in enumerate((split_c, split, split_c)):
        q = qs[i]
        moved = (q * dead[:, :, None]).sum(dim=1)            # (N, W)
        qs[i] = q * slot_ok[:, :, None] + moved[:, None, :] * sp

    # 4. backlog toward unroutable dests goes home (is dropped)
    before = src.sum()
    src = src * routable_c
    dropped = dropped + before - src.sum()

    new = (qs[0], qs[1], qs[2], src, pend, stage2)
    return (tuple(a.to(dt) for a, dt in zip(new, dtypes)),
            float(dropped))
