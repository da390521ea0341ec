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
``device="cpu"`` is passed.  Fault schedules (``events=``), the
observability hooks and ``simulate_placement`` are not ported yet.
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
from .kernel import make_step_sparse, resolve_dtype
from .tables import RouteTables, build_tables

__all__ = [
    "SimConfig", "SimRun", "SimSweep", "Simulator", "simulate",
    "saturation_sweep", "fluid_routing_spec", "DEFAULT_LOAD_GRID",
    "SIM_MAX_CELLS", "RouteTables", "build_tables",
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
    run asked for ``per_dest=True``).  ``device`` names where it ran."""

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
    dest_stability_min: float = float("nan")
    dest_stability_mean: float = float("nan")
    history: dict = field(repr=False, default_factory=dict)


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
        if self.backend == "fused":
            self._step = make_step_sparse(self.tables, config, self.dtype,
                                          dest_cols=self.dest_cols)
        else:
            self._step = make_step(self.tables, config, self.dtype)

    def default_steps(self) -> int:
        """Enough steps for the slowest feedback loop to settle: several
        two-leg traversals plus a fixed transient allowance."""
        dmax = int(self.tables.dist_act.max())
        return 48 + 16 * 2 * dmax

    def run(self, demand: np.ndarray, offered: float,
            steps: int | None = None, window: int | None = None,
            per_dest: bool = False) -> SimRun:
        """Open-loop run: every source offers ``offered * demand[s, :]``
        per step; measurements average the trailing ``window`` steps.
        ``demand`` is a dense (N, N) matrix (diagonal and inactive
        columns zero).  ``per_dest=True`` also tracks per-dest-column
        mass conservation over the window (``dest_stability_*``)."""
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
        steps = self.default_steps() if steps is None else int(steps)
        window = max(steps // 3, 8) if window is None else int(window)
        window = min(window, steps)

        # the per-step quanta are formed on the host exactly as the
        # reference forms them, then moved to the device once
        npdt = _NP_DTYPE[self.dtype]
        inj_np = (offered * inj_norm_run).astype(npdt)
        inj_cap_np = (self.config.inj_factor
                      * inj_np.sum(axis=1)).astype(npdt)
        inj = torch.from_numpy(inj_np).to(self.device)
        inj_cap = torch.from_numpy(inj_cap_np).to(self.device)
        total = float(inj_norm.sum())

        st = init_state(t, self.dtype, dest_cols=cols).as_tuple()
        # hazard: the reference reads each step's stats back to the host
        # (a device->host copy and a stall per step); the history stays
        # on the device here and is read once after the loop
        hist = torch.empty((steps, 6), dtype=torch.float64,
                           device=self.device)
        win_start = steps - window
        off_dest = (torch.from_numpy(inj_np.astype(np.float64).sum(axis=0))
                    .to(self.device) if per_dest else None)
        pd_mass0 = pd_off = pd_last = None
        for i in range(steps):
            st, stats = self._step(st, inj, inj_cap)
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
        hist = hist.cpu().numpy()        # the run's one device->host read

        w = hist[-window:]
        delivered_rate = float(w[:, 0].mean())
        accepted_rate = float(w[:, 1].mean())
        occupancy = float(w[:, 3].mean())
        src_backlog = float(hist[-1, 4])
        injected_cum = float(hist[:, 2].sum())
        delivered_cum = float(hist[:, 0].sum())
        residual = abs(injected_cum - delivered_cum - float(hist[-1, 3])
                       - src_backlog) / max(injected_cum, 1e-30)
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
        return SimRun(
            routing=self.config.routing, offered=float(offered),
            theta=delivered_rate / total, delivered_rate=delivered_rate,
            accepted_rate=accepted_rate, latency=latency, alpha=alpha,
            occupancy=occupancy, src_backlog=src_backlog, residual=residual,
            steps=steps, window=window, backend=self.backend,
            device=str(self.device),
            dest_stability_min=dest_stab_min,
            dest_stability_mean=dest_stab_mean,
            history={"delivered": hist[:, 0] / total,
                     "accepted": hist[:, 1] / total,
                     "offered": hist[:, 2] / total,
                     "occupancy": hist[:, 3], "src_backlog": hist[:, 4],
                     "diverted": hist[:, 5]})


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
             normalize: bool = True, device=None) -> SimRun:
    """Simulate one (pattern, routing, offered load) point.  ``pattern``
    is any traffic spec (registry name, TrafficPattern, or raw (N, N)
    matrix); ``offered`` is the injection rate of the busiest source in
    link-equivalents.  ``config``'s routing field is superseded by
    ``routing``."""
    cfg = _config_with(config, routing)
    _, demand, targets_mask = _demand_for(g, pattern, targets_mask, normalize)
    return Simulator(g, cfg, targets_mask, demand=demand,
                     device=device).run(demand, offered, steps)


def saturation_sweep(g: Graph, pattern, routing: str = "minimal",
                     loads=None, steps: int | None = None,
                     config: SimConfig | None = None,
                     targets_mask: np.ndarray | None = None,
                     refine: int = 3, stable_ratio: float = 0.98,
                     theta_analytic: float | None = None,
                     knee: str = "aggregate", device=None) -> SimSweep:
    """Latency-vs-offered-load curve and measured saturation throughput
    for one (topology, pattern, routing).

    ``theta_analytic`` is the fluid-model reference: when it is None the
    sweep computes it with :func:`repro_torch.core.saturation_report`
    under the matching analytic model (:func:`fluid_routing_spec`), on the
    same device.  ``loads`` defaults to :data:`DEFAULT_LOAD_GRID` times
    it, and the grid is extended when every probe lands on one side.  ``theta`` is the largest offered load
    whose delivered/offered ratio stays >= ``stable_ratio``, sharpened by
    ``refine`` bisection probes.  ``knee="per_dest"`` judges stability by
    the minimum per-dest-column ratio instead."""
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
        return simr.run(demand, lam, steps, per_dest=per_dest)

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
