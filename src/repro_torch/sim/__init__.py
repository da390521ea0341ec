"""repro_torch.sim — the flow-level network simulator on PyTorch: the
queueing-dynamics ground truth behind the analytic theta tables.

Counterpart of ``repro.sim``.  Demand matrices (every traffic pattern or
an ad-hoc matrix) replay through a time-stepped simulator whose state is
``(router, out-slot, dest)`` tensors on the card, under ``minimal`` /
``valiant`` / per-hop ``ugal_threshold(T)`` routing with three virtual
channels, finite buffers and credit backpressure.

Entry points: ``simulate(g, pattern, routing=..., offered=...)`` runs one
offered load; ``saturation_sweep`` ramps offered load and measures the
saturation knee ``theta``, comparable to the analytic theta in the
zero-threshold / infinite-buffer limit.  Both run on the card unless
``device="cpu"`` is passed, and both take a fault schedule
(``events=``, :mod:`repro_torch.sim.faults`): at each event the run
swaps in route tables compiled for the new fault state and passes the
live state through the surgery.  ``simulate_placement`` replays a
placed training job's step (:mod:`repro_torch.fabric.placement`).

Under an active :mod:`repro_torch.obs` session the simulator publishes
what the reference's does (spans, the run's conservation counters, the
balance statistics; with series on, the per-step occupancy series and
the per-dest stability; with a flight recorder or a watchdog armed, the
per-step monitor).  With no session, or a session with neither series
nor recorder nor watchdog, a run adds no launch, no host read and no
sync on the card: the history stays there and is read once a run.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from .. import obs
from .._device import resolve_device
from ..core.graph import Graph
from ..core.traffic import make_pattern, normalize_demand, saturation_report
from .engine import (SIM_MAX_CELLS, SimConfig, SimState, init_state,
                     make_step, parse_sim_routing, pick_backend)
from .faults import FaultEvent, apply_fault_surgery, normalize_events
from .kernel import make_step_sparse, resolve_dtype
from .tables import RouteTables, build_tables

__all__ = [
    "SimConfig", "SimRun", "SimSweep", "Simulator", "simulate",
    "saturation_sweep", "fluid_routing_spec", "DEFAULT_LOAD_GRID",
    "SIM_MAX_CELLS", "RouteTables", "build_tables", "FaultEvent",
    "apply_fault_surgery", "normalize_events", "simulate_placement",
]

# offered-load grid of a sweep, as fractions of the analytic fluid theta
DEFAULT_LOAD_GRID = (0.3, 0.6, 0.85, 1.0, 1.2)

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def fluid_routing_spec(sim_routing) -> str:
    """The analytic routing spec whose fluid theta the simulator
    converges to in the zero-threshold / infinite-buffer limit."""
    mode, t = parse_sim_routing(sim_routing)
    if mode == "ugal" and np.isinf(t):
        return "minimal"
    return {"minimal": "minimal", "valiant": "valiant", "ugal": "ugal"}[mode]


@dataclass
class SimRun:
    """Steady-state measurements of one (demand, routing, offered) run.

    ``theta`` is the delivered per-step throughput in the demand's own
    normalization; ``latency`` the Little's-law mean steps in the
    network; ``alpha`` the fraction of accepted fluid never diverted;
    ``residual`` the relative flow-conservation defect.
    ``dest_stability_min`` / ``_mean`` are the per-dest-column
    delivered/offered ratios over the trailing window (NaN unless the
    run asked for ``per_dest=True``).  ``device`` names where it ran.
    ``dropped`` is the fluid lost to fault surgery, ``faults`` the final
    fault state's label, and ``link_util`` the final state's occupancy
    of every live out-slot clipped at capacity, over capacity (below
    saturation the per-link flit rate).  ``totals`` holds the run's own
    cumulative sums in the step stats' units (``injected``,
    ``delivered``, ``accepted``, ``diverted``): the floats its residual
    and alpha consume, and what an obs session's ``sim.*`` counters
    add."""

    routing: str
    offered: float
    theta: float
    delivered_rate: float
    accepted_rate: float
    latency: float
    alpha: float
    occupancy: float
    src_backlog: float
    residual: float
    steps: int
    window: int
    backend: str
    device: str
    dropped: float = 0.0
    faults: str | None = None
    dest_stability_min: float = float("nan")
    dest_stability_mean: float = float("nan")
    history: dict = field(repr=False, default_factory=dict)
    link_util: np.ndarray | None = field(repr=False, default=None)
    totals: dict = field(repr=False, default_factory=dict)


@dataclass
class SimSweep:
    """A latency-vs-offered-load curve plus the measured saturation
    throughput ``theta``: the largest offered load the fabric sustains
    (delivered/offered >= ``stable_ratio``, or the minimum per-dest ratio
    under ``knee="per_dest"``), refined by bisection.
    ``theta_unstable`` is the smallest offered load seen to collapse."""

    pattern: str
    routing: str
    theta: float
    theta_unstable: float
    theta_analytic: float
    stable_ratio: float
    loads: np.ndarray
    delivered: np.ndarray
    latency: np.ndarray
    alpha: np.ndarray
    knee: str = "aggregate"
    runs: list = field(repr=False, default_factory=list)


class Simulator:
    """One simulator instance: route tables + a step function for a
    ``(graph, active set, config)`` triple on one device, reusable across
    demand matrices and offered loads."""

    def __init__(self, g: Graph, config: SimConfig = SimConfig(),
                 targets_mask: np.ndarray | None = None,
                 demand: np.ndarray | None = None, device=None):
        self.device = resolve_device(device)
        self.g = g
        self.config = config
        if config.compact not in ("auto", "off"):
            raise ValueError(f"unknown compact mode {config.compact!r}; "
                             f"options: auto, off")
        if targets_mask is None:
            targets_mask = g.meta.get("leaf_mask")
        self.active = (np.arange(g.n) if targets_mask is None
                       else np.nonzero(np.asarray(targets_mask, bool))[0])
        m_dense = len(self.active)
        used = None
        if demand is not None and config.compact == "auto":
            used = np.asarray(demand)[:, self.active].sum(axis=0) > 0
        # static dest compaction, phase 1 — the active set itself: under
        # minimal routing every dest column evolves independently, so
        # dropping never-addressed columns is exact on every backend
        if used is not None and config.mode == "minimal" and not used.all():
            self.active = self.active[used]
            used = None
        dense_cells = g.n * g.max_degree * len(self.active)
        self.backend = pick_backend(config.backend, dense_cells)
        if self.backend == "dense" and dense_cells > SIM_MAX_CELLS:
            raise ValueError(
                f"simulation state is dense (router, out-slot, dest) "
                f"tensors: {dense_cells} cells > "
                f"SIM_MAX_CELLS={SIM_MAX_CELLS}.  Use backend='fused' (the "
                f"blocked sparse-dest step) or a smaller instance.")
        # phase 2 — the per-VC dest axis: ugal/valiant keep the active
        # set whole, but the final-destination axes of the fused step
        # carry only the demanded columns
        self.dest_cols = None
        if (used is not None and config.mode in ("ugal", "valiant")
                and self.backend == "fused" and not used.all()):
            self.dest_cols = np.nonzero(used)[0]
        m_comp = (len(self.active) if self.dest_cols is None
                  else len(self.dest_cols))
        obs.gauge("sim.dest_cols.dense").set(float(m_dense))
        obs.gauge("sim.dest_cols.compacted").set(float(m_comp))
        obs.gauge("sim.compact_ratio").set(m_comp / max(m_dense, 1))
        self.dtype = resolve_dtype(config.dtype, self.backend)
        with obs.span("sim.build_tables", backend=self.backend, n=g.n,
                      dests=len(self.active)):
            self.tables = build_tables(g, self.active, dtype=self.dtype,
                                       device=self.device)
            self._step = self._make_step(self.tables)
        obs.counter(f"sim.backend[{self.backend}]").add(1.0)
        # fault-state label -> (tables, step): one build per fault state
        # serves every run and every probe of a sweep
        self._fault_cache: dict = {}

    def _make_step(self, tb: RouteTables):
        if self.backend == "fused":
            return make_step_sparse(tb, self.config, self.dtype,
                                    dest_cols=self.dest_cols)
        return make_step(tb, self.config, self.dtype)

    def _tables_for(self, fs):
        """Route tables and step for one fault state (None or an empty
        FaultSet: the pristine pair)."""
        if fs is None or fs.empty:
            return self.tables, self._step
        key = fs.label
        if key not in self._fault_cache:
            with obs.span("sim.fault_tables", label=key):
                tb = build_tables(self.g, self.active, dtype=self.dtype,
                                  faults=fs, device=self.device)
                self._fault_cache[key] = (tb, self._make_step(tb))
        return self._fault_cache[key]

    def default_steps(self, events=None) -> int:
        """Enough steps for the slowest feedback loop to settle: several
        two-leg traversals plus a fixed transient allowance.  Faults can
        lengthen routes, so the sizing takes the largest distance over
        every fault segment's tables."""
        dmax = int(self.tables.dist_act.max())
        for e in normalize_events(events):
            if not e.faults.empty:
                tb, _ = self._tables_for(e.faults)
                dmax = max(dmax, int(tb.dist_act.max()))
        return 48 + 16 * 2 * dmax

    def run(self, demand: np.ndarray, offered: float,
            steps: int | None = None, window: int | None = None,
            events=None, per_dest: bool = False) -> SimRun:
        """Open-loop run: every source offers ``offered * demand[s, :]``
        per step; measurements average the trailing ``window`` steps.
        ``demand`` is a dense (N, N) matrix (diagonal and inactive
        columns zero).

        ``events`` is a fault schedule: FaultEvents or ``(step,
        FaultSet)`` pairs, each the cumulative fault state from that step
        on.  At each boundary the run swaps in tables compiled for the
        new fault state and passes the live fluid through
        :func:`repro_torch.sim.faults.apply_fault_surgery`; sources stop
        being offered fluid toward unroutable dests.  theta is measured
        against the final fault state's surviving demand, so one event at
        step 0 is comparable to the analytic ``degraded_report`` theta.

        ``per_dest=True`` also tracks per-dest-column mass conservation
        over the window (``dest_stability_*``).

        Under an active :mod:`repro_torch.obs` session the run publishes
        its conservation counters (``sim.injected`` / ``sim.delivered`` /
        ``sim.accepted`` / ``sim.diverted`` / ``sim.dropped``: the SAME
        floats this method's residual/alpha accounting uses, so they
        match the returned :class:`SimRun` bit for bit) and the
        link-utilization balance statistics.  With series on (trace
        mode) it also publishes the per-VC occupancy series and the
        per-dest-column stability; their digests accumulate on the
        device and are read once after the loop.  A flight recorder or a
        watchdog on the session arms the per-step monitor, which reads
        one small digest vector back each step, so a halting watchdog
        stops at the step the reference's stops at: that read is the
        monitor's cost."""
        with obs.span("sim.run", routing=self.config.routing,
                      offered=float(offered), backend=self.backend):
            return self._run(demand, offered, steps, window, events,
                             per_dest)

    def _run(self, demand, offered, steps, window, events,
             per_dest) -> SimRun:
        t = self.tables
        demand = np.asarray(demand, dtype=np.float64)
        if demand.shape != (t.n, t.n):
            raise ValueError(f"demand is {demand.shape}, graph has N={t.n}")
        inj_norm = demand[:, self.active]
        lost = demand.sum() - inj_norm.sum()
        if lost > 1e-9 * max(demand.sum(), 1.0):
            raise ValueError("demand addresses routers outside the active "
                             "set; pass a matching targets_mask")
        if np.abs(np.diagonal(demand)).sum() > 1e-9 * max(demand.sum(), 1.0):
            raise ValueError("demand has self-addressed (diagonal) entries; "
                             "zero the diagonal (TrafficPattern.demand "
                             "already does)")
        if inj_norm.sum() <= 0:
            raise ValueError("demand matrix is all zero")
        cols = self.dest_cols
        if cols is not None:
            off_cols = inj_norm.sum(axis=0)
            outside = float(off_cols.sum() - off_cols[cols].sum())
            if outside > 1e-9 * max(float(off_cols.sum()), 1.0):
                raise ValueError(
                    "demand addresses destination columns outside the "
                    "compacted dest axis this Simulator was built for; "
                    "rebuild with Simulator(demand=...) covering them, "
                    "or SimConfig(compact='off')")
            inj_norm_run = inj_norm[:, cols]
        else:
            inj_norm_run = inj_norm
        evs = normalize_events(events)
        steps = (self.default_steps(events=evs) if steps is None
                 else int(steps))
        window = max(steps // 3, 8) if window is None else int(window)
        window = min(window, steps)
        if evs and evs[-1].step >= steps:
            raise ValueError(f"fault event at step {evs[-1].step} is past "
                             f"the run's {steps} steps")
        # segments of constant fault state: (start, end, FaultSet | None)
        marks = [] if evs and evs[0].step == 0 else [(0, None)]
        marks += [(e.step, e.faults) for e in evs]
        segs = [(s0, (marks[i + 1][0] if i + 1 < len(marks) else steps), fs)
                for i, (s0, fs) in enumerate(marks)]

        # the per-step quanta are formed on the host exactly as the
        # reference forms them, then moved to the device once a segment
        npdt = _NP_DTYPE[self.dtype]
        inj_np = (offered * inj_norm_run).astype(npdt)

        st = init_state(t, self.dtype, dest_cols=cols).as_tuple()
        # hazard: the reference reads each step's stats back to the host
        # (a device->host copy and a stall per step); the history stays
        # on the device here and is read once after the loop
        hist = torch.empty((steps, 6), dtype=torch.float64,
                           device=self.device)
        # each segment's history is normalized by its own fault state's
        # surviving demand
        seg_total = np.empty(steps, dtype=np.float64)
        dropped_total = 0.0
        tb = t
        # per-step series capture is opt-in (a session with series on):
        # `cap is None` is the only per-step cost otherwise
        sess = obs.current()
        live = sess is not None and sess.enabled
        cap = (_SimCapture(sess, self.config, steps, window, self.device)
               if live and sess.series else None)
        # flight recorder + watchdog ride the same seam: `mon is None` is
        # the whole cost without them
        rec = sess.recorder if live else None
        wd = sess.watchdog if live else None
        if wd is not None and wd.exhausted:
            wd = None
        mon = None
        if rec is not None or wd is not None:
            if wd is not None:
                fp = hashlib.sha256(
                    np.ascontiguousarray(inj_norm).tobytes()).hexdigest()
                wd.begin_run(config=asdict(self.config),
                             backend=self.backend, device=str(self.device),
                             offered=float(offered), steps=steps,
                             window=window, n=t.n,
                             dests=len(self.active),
                             demand_fingerprint=fp[:16])
            mon = _StepMonitor(rec, wd, self.device)
        win_start = steps - window
        pd_mass0 = pd_off = pd_last = None
        for s0, s1, fs in segs:
            tb, step_fn = self._tables_for(fs)
            if fs is not None:
                with obs.span("sim.fault_surgery", label=fs.label,
                              step=s0):
                    st, dropped = apply_fault_surgery(st, tb,
                                                      dest_cols=cols)
                dropped_total += dropped
                obs.counter("sim.fault_events").add(1.0)
            if tb.faulted:
                rt_full = tb.routable.cpu().numpy()
                rt = rt_full if cols is None else rt_full[:, cols]
                inj_seg = (inj_np * rt).astype(npdt)
                seg_total[s0:s1] = float((inj_norm * rt_full).sum())
            else:
                inj_seg = inj_np
                seg_total[s0:s1] = float(inj_norm.sum())
            inj_cap_np = (self.config.inj_factor
                          * inj_seg.sum(axis=1)).astype(npdt)
            inj = torch.from_numpy(inj_seg).to(self.device)
            inj_cap = torch.from_numpy(inj_cap_np).to(self.device)
            off_dest = (torch.from_numpy(inj_seg.astype(np.float64)
                                         .sum(axis=0)).to(self.device)
                        if per_dest else None)
            if cap is not None:
                cap.set_segment(tb, inj_seg)
            if mon is not None:
                mon.set_segment(float(seg_total[s0]),
                                inj_seg.astype(np.float64).sum(axis=0)
                                if mon.stab_win else None,
                                dropped_total)
            for i in range(s0, s1):
                st, stats = step_fn(st, inj, inj_cap)
                hist[i] = stats
                if cap is not None or mon is not None:
                    occ = _occ_sums(st)
                    if cap is not None:
                        cap.on_step(i, st, occ)
                    if mon is not None:
                        mon.on_step(i, st, hist[i], occ)
                if per_dest and i >= win_start:
                    dm = _dest_mass(st)
                    if pd_mass0 is None:
                        pd_mass0 = dm
                        pd_off = torch.zeros_like(dm)
                    else:
                        pd_off = pd_off + off_dest
                    pd_last = dm
        self.last_state = SimState(*st)
        # the final state's per-slot occupancy clipped at capacity, over
        # the live slots
        capacity = float(self.config.capacity)
        o_tot = sum(q.sum(dim=-1, dtype=torch.float64) for q in st[:3])
        link_util = (o_tot[tb.slot_ok].clamp(max=capacity)
                     / capacity).cpu().numpy()
        hist = hist.cpu().numpy()        # the run's one history read

        # theta in the final fault state's surviving demand units
        total = float(seg_total[-1])
        if total <= 0:
            raise ValueError("faults removed every offered demand")
        norm = np.where(seg_total > 0, seg_total, np.inf)
        w = hist[-window:]
        delivered_rate = float(w[:, 0].mean())
        accepted_rate = float(w[:, 1].mean())
        occupancy = float(w[:, 3].mean())
        src_backlog = float(hist[-1, 4])
        injected_cum = float(hist[:, 2].sum())
        delivered_cum = float(hist[:, 0].sum())
        residual = abs(injected_cum - delivered_cum - float(hist[-1, 3])
                       - src_backlog - dropped_total) \
            / max(injected_cum, 1e-30)
        acc_cum = float(hist[:, 1].sum())
        div_cum = float(hist[:, 5].sum())
        alpha = 1.0 - div_cum / max(acc_cum, 1e-30)
        latency = occupancy / max(delivered_rate, 1e-30)
        dest_stab_min = dest_stab_mean = float("nan")
        if per_dest and pd_last is not None:
            pd_off = pd_off.cpu().numpy()
            sel = pd_off > 0
            if sel.any():
                delivered_d = (pd_mass0 - pd_last).cpu().numpy() + pd_off
                stab = np.clip(delivered_d[sel] / pd_off[sel], 0.0, None)
                dest_stab_min = float(stab.min())
                dest_stab_mean = float(stab.mean())
        final_fs = segs[-1][2]
        if live:
            # publish the run's own accounting: the SAME float values the
            # residual/alpha identities above consumed, so the counters
            # equal the returned SimRun's bit for bit
            m = sess.metrics
            m.counter("sim.runs").add(1.0)
            m.counter("sim.steps").add(float(steps))
            m.counter("sim.injected").add(injected_cum)
            m.counter("sim.delivered").add(delivered_cum)
            m.counter("sim.accepted").add(acc_cum)
            m.counter("sim.diverted").add(div_cum)
            m.counter("sim.dropped").add(dropped_total)
            m.gauge("sim.final_occupancy").set(float(hist[-1, 3]))
            m.gauge("sim.final_src_backlog").set(src_backlog)
            m.gauge("sim.residual").set(residual)
            m.gauge("sim.alpha").set(alpha)
            m.gauge("sim.delivered_rate").set(delivered_rate)
            m.gauge("sim.theta").set(delivered_rate / total)
            if cap is not None:
                cap.finalize(hist)
            else:
                # the final state's per-link utilization, already on the
                # host as SimRun.link_util: below saturation every queue
                # drains each step, so this IS the per-link flit rate
                m.histogram("sim.link_util_final").observe_many(link_util)
                _publish_balance(m, link_util)
        return SimRun(
            routing=self.config.routing, offered=float(offered),
            theta=delivered_rate / total, delivered_rate=delivered_rate,
            accepted_rate=accepted_rate, latency=latency, alpha=alpha,
            occupancy=occupancy, src_backlog=src_backlog, residual=residual,
            steps=steps, window=window, backend=self.backend,
            device=str(self.device), dropped=dropped_total,
            faults=(None if final_fs is None or final_fs.empty
                    else final_fs.label),
            dest_stability_min=dest_stab_min,
            dest_stability_mean=dest_stab_mean,
            history={"delivered": hist[:, 0] / norm,
                     "accepted": hist[:, 1] / norm,
                     "offered": hist[:, 2] / norm,
                     "occupancy": hist[:, 3], "src_backlog": hist[:, 4],
                     "diverted": hist[:, 5],
                     "fault_events": np.array([e.step for e in evs],
                                              dtype=np.int64)},
            link_util=link_util,
            totals={"injected": injected_cum, "delivered": delivered_cum,
                    "accepted": acc_cum, "diverted": div_cum})


def _dest_mass(st) -> torch.Tensor:
    """Per-FINAL-dest fluid mass of a step state, float64, on the state's
    device: vc0 + vc2 queues + source backlog + the (mid, dest) pool
    column sums.  vc1 and stage2 fluid is addressed to intermediates and
    its final-dest split IS the pend pool, so adding it would double
    count."""
    q0, _q1, q2, src, pend, _stage2 = st
    f64 = torch.float64
    return (q0.sum(dim=(0, 1), dtype=f64) + q2.sum(dim=(0, 1), dtype=f64)
            + src.sum(dim=0, dtype=f64) + pend.sum(dim=0, dtype=f64))


def _occ_sums(st) -> torch.Tensor:
    """The per-VC occupancy of a step state, float64, on its device:
    ``(vc0, vc1 + stage2, vc2)``.  stage2 fluid is converted-but-unlaunched
    phase-1 mass, counted with vc1 (where its credit lives).  The sums
    reduce the state's own dtype into float64 without copying it."""
    q0, q1, q2, _src, _pend, stage2 = st
    f64 = torch.float64
    return torch.stack([q0.sum(dtype=f64),
                        q1.sum(dtype=f64) + stage2.sum(dtype=f64),
                        q2.sum(dtype=f64)])


def _publish_balance(m, util) -> None:
    """Gauge the balance statistics of a per-link utilization vector —
    the paper's balanced-utilization thesis as a measured number."""
    bs = obs.balance_stats(util)
    m.gauge("sim.balance.gini").set(bs["gini"])
    m.gauge("sim.balance.p99_over_mean").set(bs["p99_over_mean"])
    m.gauge("sim.balance.max_over_mean").set(bs["max_over_mean"])


class _SimCapture:
    """Per-step series capture for one :meth:`Simulator.run` under an
    active obs session with series on (trace mode by default).

    Publishes the per-VC occupancy / injection-stall / diverted-fraction
    series, the trailing window's per-arc forwarded mass as the measured
    ``sim.link_util`` histogram + balance gauges, and the per-dest-column
    stability ``sim.dest_stability`` (per-dest mass at the window edges
    plus the offered inflow between them).  Where the reference sums
    each step's state on the host, every digest here accumulates on the
    device, and :meth:`finalize` reads them once after the run's history
    read: series capture costs device work each step and a few reads a
    run.  A run that a halting watchdog stops publishes no series (the
    flight recorder's window carries that story)."""

    def __init__(self, sess, cfg: SimConfig, steps: int, window: int,
                 device):
        self.m = sess.metrics
        self.cap = float(cfg.capacity)
        self.win_start = steps - window
        self.device = device
        self.occ = torch.zeros((steps, 3), dtype=torch.float64,
                               device=device)
        self.tb = None
        self.off_dest = None    # (W,) per-step offered mass per dest
        self.util_sum = None    # (N, K) window forwarded-mass accumulator
        self.n_win = 0
        self.mass0 = None       # per-dest mass at the first window step
        self.off_acc = None     # offered mass between the mass snapshots
        self.mass_last = None

    def set_segment(self, tb, inj_seg: np.ndarray) -> None:
        self.tb = tb
        self.off_dest = torch.from_numpy(
            inj_seg.astype(np.float64).sum(axis=0)).to(self.device)

    def on_step(self, i: int, st, occ) -> None:
        self.occ[i] = occ
        if i < self.win_start:
            return
        # forwarded mass next step = min(occupancy, capacity) per arc
        # (processor sharing), sampled post-step
        f64 = torch.float64
        q0, q1, q2 = st[:3]
        o_tot = (q0.sum(dim=-1, dtype=f64) + q1.sum(dim=-1, dtype=f64)
                 + q2.sum(dim=-1, dtype=f64))
        if self.util_sum is None:
            self.util_sum = torch.zeros_like(o_tot)
            self.mass0 = _dest_mass(st)
            self.off_acc = torch.zeros_like(self.mass0)
        else:
            self.off_acc = self.off_acc + self.off_dest
        self.util_sum += o_tot.clamp(max=self.cap)
        self.n_win += 1
        self.mass_last = _dest_mass(st)

    def finalize(self, hist: np.ndarray) -> None:
        m = self.m
        occ = self.occ.cpu().numpy()
        for name, vals in (
                ("sim.occ_vc0", occ[:, 0]), ("sim.occ_vc1", occ[:, 1]),
                ("sim.occ_vc2", occ[:, 2]), ("sim.src_backlog", hist[:, 4]),
                ("sim.diverted_frac",
                 hist[:, 5] / np.maximum(hist[:, 1], 1e-30)),
                ("sim.inj_stalled", np.maximum(hist[:, 2] - hist[:, 1],
                                               0.0))):
            s = m.series(name)
            for v in vals:
                s.append(float(v))
        if self.util_sum is None or self.tb is None or self.n_win == 0:
            return
        util = (self.util_sum[self.tb.slot_ok]
                / (self.n_win * self.cap)).cpu().numpy()
        m.histogram("sim.link_util").observe_many(util)
        _publish_balance(m, util)
        if self.n_win >= 2:
            # per-dest conservation over the window: delivered mass =
            # mass drop + offered inflow between the snapshots
            delivered = (self.mass0 - self.mass_last
                         + self.off_acc).cpu().numpy()
            off_acc = self.off_acc.cpu().numpy()
            sel = off_acc > 0
            if sel.any():
                stab = np.clip(delivered[sel] / off_acc[sel], 0.0, None)
                m.histogram("sim.dest_stability").observe_many(stab)
                m.gauge("sim.dest_stability.min").set(float(stab.min()))
                m.gauge("sim.dest_stability.mean").set(float(stab.mean()))


class _StepMonitor:
    """Flight-recorder + watchdog hook for one :meth:`Simulator.run`:
    computes the shared per-step digests ONCE and feeds both.

    Recorder channels mirror ``SimRun.history`` — delivered / accepted /
    offered divided per step by the SAME per-segment norm the run's
    post-loop normalization uses (IEEE float64 division is elementwise
    deterministic, so a reloaded bundle window equals the history arrays
    bit for bit), occupancy / src_backlog / diverted raw — plus the
    per-VC occupancy sums and the running conservation residual.

    The digests are formed on the device — the step's stats row in
    float64, the per-VC occupancy sums, and, only while a dest_stability
    trigger is armed, the per-dest mass (a float64 reduction of the
    state, never a float64 copy of it) with its trailing-window
    stability minimum and argmin — and read back as one small vector a
    step.  Per-step wall time is taken only while a step_time trigger is
    armed; the read makes it cover the step's device work."""

    def __init__(self, rec, wd, device):
        self.rec = rec
        self.wd = wd
        self.device = device
        self.stab_win = wd.stability_window() if wd is not None else None
        self.need_time = wd is not None and wd.needs("step_seconds")
        self._mass_hist = (deque(maxlen=self.stab_win + 1)
                           if self.stab_win else None)
        self.norm = np.inf
        self._sel = None         # host indices of the offered dest columns
        self._sel_dev = None
        self._off_w = None       # their offered mass times the window
        self.dropped = 0.0
        self.inj_cum = 0.0
        self.dlv_cum = 0.0
        self._t_prev = time.perf_counter()

    def set_segment(self, seg_total: float, off_dest, dropped: float):
        self.norm = seg_total if seg_total > 0 else np.inf
        self.dropped = dropped
        if off_dest is not None:
            sel = np.nonzero(off_dest > 0)[0]
            self._sel = sel
            self._sel_dev = torch.as_tensor(sel, device=self.device)
            self._off_w = torch.from_numpy(
                off_dest[sel] * self.stab_win).to(self.device)

    def on_step(self, i: int, st, row, occ) -> None:
        """``row`` is the step's float64 history row on the device."""
        f64 = torch.float64
        parts = [row, occ]
        have_stab = False
        if self._mass_hist is not None:
            dm = _dest_mass(st)
            self._mass_hist.append(dm)
            parts.append(dm.min().reshape(1))
            if (len(self._mass_hist) == self.stab_win + 1
                    and self._sel is not None and len(self._sel)):
                # delivered per column over the trailing window = mass
                # drop + offered inflow, evaluated live each step
                sel = self._sel_dev
                delivered = (self._mass_hist[0].index_select(0, sel)
                             - dm.index_select(0, sel) + self._off_w)
                stab = delivered / self._off_w
                j = torch.argmin(stab)
                parts += [stab[j].reshape(1), j.to(f64).reshape(1)]
                have_stab = True
        vals = torch.cat(parts).cpu().numpy()    # the step's one read
        dt = None
        if self.need_time:
            now = time.perf_counter()
            dt = now - self._t_prev
            self._t_prev = now
        row = vals[:6]
        self.inj_cum += float(row[2])
        self.dlv_cum += float(row[0])
        # the run's conservation identity, evaluated live
        residual = (abs(self.inj_cum - self.dlv_cum - float(row[3])
                        - float(row[4]) - self.dropped)
                    / max(self.inj_cum, 1e-30))
        stab_min = float("nan")
        stab_col = mass_min = None
        if self._mass_hist is not None:
            mass_min = float(vals[9])
            if have_stab:
                stab_min = float(vals[10])
                stab_col = int(self._sel[int(vals[11])])
        if self.rec is not None:
            ch = {"delivered": float(row[0] / self.norm),
                  "accepted": float(row[1] / self.norm),
                  "offered": float(row[2] / self.norm),
                  "occupancy": float(row[3]),
                  "src_backlog": float(row[4]),
                  "diverted": float(row[5]),
                  "occ_vc0": float(vals[6]),
                  "occ_vc1": float(vals[7]),
                  "occ_vc2": float(vals[8]),
                  "residual": residual}
            if self._mass_hist is not None:
                ch["dest_stability_min"] = stab_min
            self.rec.record(i, ch)
        if self.wd is not None:
            sample = {"step": i, "delivered": float(row[0]),
                      "accepted": float(row[1]),
                      "offered": float(row[2]),
                      "occupancy": float(row[3]),
                      "src_backlog": float(row[4]),
                      "diverted": float(row[5]),
                      "residual": residual}
            if dt is not None:
                sample["step_seconds"] = dt
            if mass_min is not None:
                sample["dest_mass_min"] = mass_min
                sample["dest_stability_min"] = stab_min
                if stab_col is not None:
                    sample["dest_stability_col"] = stab_col
            self.wd.on_step(sample)


def _demand_for(g: Graph, pattern, targets_mask, normalize: bool):
    if targets_mask is None:
        targets_mask = g.meta.get("leaf_mask")
    pat = make_pattern(pattern)
    demand = pat.demand(g, targets_mask)
    if normalize:
        demand = normalize_demand(demand)
    return pat, demand, targets_mask


def _config_with(config: SimConfig | None, routing: str) -> SimConfig:
    base = config or SimConfig()
    parse_sim_routing(routing)  # validate before building tables
    return SimConfig(routing=routing, buffer=base.buffer,
                     capacity=base.capacity, inj_factor=base.inj_factor,
                     backend=base.backend, dtype=base.dtype,
                     compact=base.compact)


def simulate(g: Graph, pattern, routing: str = "minimal",
             offered: float = 0.5, steps: int | None = None,
             config: SimConfig | None = None,
             targets_mask: np.ndarray | None = None,
             normalize: bool = True, events=None, device=None) -> SimRun:
    """Simulate one (pattern, routing, offered load) point.  ``pattern``
    is any traffic spec (registry name, TrafficPattern, or raw (N, N)
    matrix); ``offered`` is the injection rate of the busiest source in
    link-equivalents.  ``config``'s routing field is superseded by
    ``routing``.  ``events`` is a mid-run fault schedule (see
    :meth:`Simulator.run`)."""
    cfg = _config_with(config, routing)
    _, demand, targets_mask = _demand_for(g, pattern, targets_mask, normalize)
    return Simulator(g, cfg, targets_mask, demand=demand,
                     device=device).run(demand, offered, steps,
                                        events=events)


def saturation_sweep(g: Graph, pattern, routing: str = "minimal",
                     loads=None, steps: int | None = None,
                     config: SimConfig | None = None,
                     targets_mask: np.ndarray | None = None,
                     refine: int = 3, stable_ratio: float = 0.98,
                     theta_analytic: float | None = None,
                     events=None, knee: str = "aggregate",
                     device=None) -> SimSweep:
    """Latency-vs-offered-load curve and measured saturation throughput
    for one (topology, pattern, routing).

    ``theta_analytic`` is the fluid-model reference: when it is None the
    sweep computes it with :func:`repro_torch.core.saturation_report`
    under the matching analytic model (:func:`fluid_routing_spec`), on the
    same device.  ``loads`` defaults to :data:`DEFAULT_LOAD_GRID` times
    it, and the grid is extended when every probe lands on one side.  ``theta`` is the largest offered load
    whose delivered/offered ratio stays >= ``stable_ratio``, sharpened by
    ``refine`` bisection probes.  ``events`` applies one fault schedule
    to every probe (see :meth:`Simulator.run`): the knee is then the
    degraded saturation throughput, comparable to the analytic
    ``degraded_report`` theta of the final fault state; pass a ``loads``
    grid scaled to it.  ``knee="per_dest"`` judges stability by the
    minimum per-dest-column ratio instead."""
    if knee not in ("aggregate", "per_dest"):
        raise ValueError(f"unknown knee criterion {knee!r}; options: "
                         f"aggregate, per_dest")
    per_dest = knee == "per_dest"
    device = resolve_device(device)
    cfg = _config_with(config, routing)
    pat, demand, targets_mask = _demand_for(g, pattern, targets_mask, True)
    sweep_span = obs.span("sim.sweep", pattern=pat.name,
                          routing=cfg.routing)
    with sweep_span:
        ref = float(theta_analytic if theta_analytic is not None else
                    saturation_report(g, pat,
                                      routing=fluid_routing_spec(routing),
                                      targets_mask=targets_mask,
                                      device=device).theta)
        if loads is None:
            loads = np.asarray(DEFAULT_LOAD_GRID) * ref
        loads = np.sort(np.asarray(loads, dtype=np.float64))
        simr = Simulator(g, cfg, targets_mask, demand=demand, device=device)

        def stable(r):
            if per_dest and np.isfinite(r.dest_stability_min):
                return r.dest_stability_min >= stable_ratio
            return r.theta >= stable_ratio * r.offered

        n_probes = [0]

        def probe(lam, phase):
            # each probe is one spanned run, tagged with the sweep phase
            # (grid / bracket extension / bisection) and counted per phase
            obs.counter(f"sim.probes[{phase}]").add(1.0)
            with obs.span("sim.probe", phase=phase, offered=float(lam)):
                r = simr.run(demand, lam, steps, events=events,
                             per_dest=per_dest)
            ok = stable(r)
            n_probes[0] += 1
            # one streamed event per probe (no-op without a streaming
            # session) + the oscillation trigger's stability-frontier feed
            obs.emit("sim.probe", pattern=pat.name, routing=cfg.routing,
                     phase=phase, probe=n_probes[0], offered=float(lam),
                     theta=r.theta, latency=r.latency, stable=ok)
            s = obs.current()
            if s is not None and s.enabled and s.watchdog is not None:
                s.watchdog.on_probe(float(lam), ok)
            return r

        runs = [probe(lam, "grid") for lam in loads]
        # extend the bracket when the grid missed the knee entirely
        for _ in range(2):
            if any(stable(r) for r in runs):
                break
            runs.append(probe(0.5 * min(r.offered for r in runs),
                              "bracket"))
        for _ in range(2):
            if any(not stable(r) for r in runs):
                break
            runs.append(probe(1.4 * max(r.offered for r in runs),
                              "bracket"))

        lo = max((r.offered for r in runs if stable(r)), default=0.0)
        unstable = [r.offered for r in runs
                    if not stable(r) and r.offered > lo]
        hi = min(unstable) if unstable else float("inf")
        if lo > 0.0 and np.isfinite(hi):
            for _ in range(refine):
                r = probe(0.5 * (lo + hi), "bisect")
                runs.append(r)
                if stable(r):
                    lo = r.offered
                else:
                    hi = r.offered
        sweep_span.set(theta=lo, probes=len(runs))
    curve = sorted(runs, key=lambda r: r.offered)
    return SimSweep(
        pattern=pat.name, routing=cfg.routing, theta=lo, theta_unstable=hi,
        theta_analytic=ref, stable_ratio=stable_ratio,
        loads=np.array([r.offered for r in curve]),
        delivered=np.array([r.theta for r in curve]),
        latency=np.array([r.latency for r in curve]),
        alpha=np.array([r.alpha for r in curve]), knee=knee, runs=runs)


def simulate_placement(placement, profile, routing: str = "ugal_threshold(0)",
                       offered: float | None = None,
                       steps: int | None = None,
                       config: SimConfig | None = None,
                       axis_of=None, device=None) -> SimRun:
    """Replay a (StepProfile, Placement) byte matrix through the
    simulator in fabric.placement's normalization: demand is scaled so
    the busiest CHIP injects one unit (``chip_wire_bytes``), making the
    measured theta directly comparable to ``placement_report``'s.
    ``offered`` defaults to 1.2x the analytic theta so the run reports
    the saturation plateau.  Both run on ``device``."""
    from ..fabric.placement import (chip_wire_bytes, placement_demand,
                                    placement_report)
    device = resolve_device(device)
    cfg = _config_with(config, routing)
    demand = placement_demand(profile, placement, axis_of)
    per_chip = chip_wire_bytes(profile, placement.mesh_shape,
                               placement.axis_names, axis_of)
    if per_chip == 0.0 or not demand.any():
        raise ValueError("placement demand is all router-local; "
                         "nothing to simulate")
    norm = demand / per_chip
    if offered is None:
        ref = placement_report(placement, profile,
                               routing=fluid_routing_spec(routing),
                               axis_of=axis_of, device=device).theta
        offered = 1.2 * ref
    return Simulator(placement.graph, cfg, demand=norm,
                     device=device).run(norm, offered, steps)
