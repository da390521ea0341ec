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
placed training job's step (:mod:`repro_torch.fabric.placement`).  The
observability hooks are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

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
    saturation the per-link flit rate)."""

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
        self.dtype = resolve_dtype(config.dtype, self.backend)
        self.tables = build_tables(g, self.active, dtype=self.dtype,
                                   device=self.device)
        self._step = self._make_step(self.tables)
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
        over the window (``dest_stability_*``)."""
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
        win_start = steps - window
        pd_mass0 = pd_off = pd_last = None
        for s0, s1, fs in segs:
            tb, step_fn = self._tables_for(fs)
            if fs is not None:
                st, dropped = apply_fault_surgery(st, tb, dest_cols=cols)
                dropped_total += dropped
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
            for i in range(s0, s1):
                st, stats = step_fn(st, inj, inj_cap)
                hist[i] = stats
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
        cap = float(self.config.capacity)
        o_tot = sum(q.sum(dim=-1, dtype=torch.float64) for q in st[:3])
        link_util = (o_tot[tb.slot_ok].clamp(max=cap) / cap).cpu().numpy()
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
            link_util=link_util)


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
    ref = float(theta_analytic if theta_analytic is not None else
                saturation_report(g, pat, routing=fluid_routing_spec(routing),
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

    def probe(lam):
        return simr.run(demand, lam, steps, events=events,
                        per_dest=per_dest)

    runs = [probe(lam) for lam in loads]
    # extend the bracket when the grid missed the knee entirely
    for _ in range(2):
        if any(stable(r) for r in runs):
            break
        runs.append(probe(0.5 * min(r.offered for r in runs)))
    for _ in range(2):
        if any(not stable(r) for r in runs):
            break
        runs.append(probe(1.4 * max(r.offered for r in runs)))

    lo = max((r.offered for r in runs if stable(r)), default=0.0)
    unstable = [r.offered for r in runs if not stable(r) and r.offered > lo]
    hi = min(unstable) if unstable else float("inf")
    if lo > 0.0 and np.isfinite(hi):
        for _ in range(refine):
            r = probe(0.5 * (lo + hi))
            runs.append(r)
            if stable(r):
                lo = r.offered
            else:
                hi = r.offered
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
