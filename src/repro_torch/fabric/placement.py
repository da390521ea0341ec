"""Placement-aware demand pipeline: map logical mesh coordinates
(pod, data, model) onto the terminals of a physical fabric graph and
score the resulting traffic through the routing registry.

This closes the loop the paper leaves open: Section 2 prices UNIFORM
traffic with the closed form u = a·k̄/Δ; a training step's traffic is
structured (rings over the DP axis, all-to-all inside TP/EP groups), so
the load actually seen by each link depends on where the job's chips sit.
A ``(StepProfile, Placement)`` pair compiles into a router-level (N, N)
demand matrix (:func:`placement_demand`, reusing fabric.collectives' byte
accounting), which flows through ``arc_loads_weighted`` /
``saturation_report`` under ANY registered routing model — minimal,
Valiant, or the UGAL blend a real large-radix router runs.  theta of that
matrix (demand normalized so the busiest chip injects one unit) is the
placement analogue of Theorem 3.9's counting argument, comparable across
fabrics in Eq. 1's link-equivalent units.

Placement strategies are a registry (:data:`PLACEMENT_STRATEGIES`,
mirroring the traffic-pattern and routing registries):

  linear       chips fill routers in index order (a naive scheduler)
  group        each model-axis group is packed onto consecutive routers
               (electrical-group-aligned; for PN fabrics the subplane
               partition of Figure 2)
  random       seeded shuffle baseline
  orbit        group packing onto an automorphism-orbit-sorted router
               order (leaf columns first on indirect networks): a single
               model group spanning a whole orbit one-chip-per-router
               produces uniform-shaped demand on an automorphism-
               invariant active set, so ``arc_loads_weighted`` routes it
               through the orbit shortcut
  greedy_swap  pairwise-swap descent on max arc load under the scoring
               routing model, seeded from another strategy

``evaluate_placements`` / ``placement_search`` score strategies by theta
under a chosen routing model (default ugal — the routing the fabric
actually runs) and optionally by the worst case over
``repro_torch.core.adversary`` restricted to the routers the job occupies.

The port's counterpart of ``repro.fabric.placement``.  The demand is
built in numpy on the host, as the reference builds it (bit for bit the
same matrix); every routing evaluation runs on ``device``, the card
unless ``device="cpu"`` is passed, through the port's arc-load engines
(``engine`` ``auto`` / ``fused`` / ``dense`` / ``orbit``; ``None`` means
``auto``).  Under an obs session the pairwise-swap descent is a
``placement.greedy_swap`` span counting ``placement.swap_evals`` (each
swap it evaluates; the start's evaluation is not a swap) and
``placement.swap_accepted``, as in the reference;
``greedy_improve(return_history=True)`` carries the descent's
trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .. import obs
from .._device import resolve_device
from ..core.graph import Graph
from ..core.routing import make_routing, parse_spec
from .collectives import RING_OPS, SPREAD_OPS, bytes_on_wire

__all__ = ["Placement", "PlacementStrategy", "PLACEMENT_STRATEGIES",
           "register_placement", "make_placement_strategy", "place_mesh",
           "collective_traffic", "schedule_from_profile", "placement_demand",
           "placement_report", "link_loads", "greedy_improve",
           "evaluate_placements", "placement_search", "DEFAULT_STRATEGIES",
           "AXIS_OF_OP"]


@dataclass
class Placement:
    """chip -> router assignment for a (pod, data, model)-shaped mesh."""
    graph: Graph
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    router_of: np.ndarray  # (n_chips,) router index per flattened chip

    @property
    def n_chips(self) -> int:
        return int(np.prod(self.mesh_shape))

    @property
    def occupied(self) -> np.ndarray:
        """Sorted router ids hosting at least one chip."""
        return np.unique(self.router_of)


# ---------------------------------------------------------------------------
# Schedule -> chip traffic -> router demand
# ---------------------------------------------------------------------------

# Which mesh axis each collective kind of a StepProfile rides: gradient
# rings run over the data-parallel axis, MoE dispatch / personalized
# exchange inside the model (TP/EP) groups.
AXIS_OF_OP = {"all-reduce": "data", "all-gather": "data",
              "reduce-scatter": "data",
              "all-to-all": "model", "collective-permute": "model"}


def schedule_from_profile(profile, axis_names, axis_of=None) -> dict:
    """Map a StepProfile's per-device collective bytes onto mesh axes.

    Returns ``{axis: (kind, payload)}`` for :func:`collective_traffic`,
    with kind ``'ring'`` (DP gradient schedule) or ``'all_to_all'``
    (TP/EP group exchange).  Byte accounting delegates to
    fabric.collectives: the ring kind prices the all-reduce wire bytes
    2(n-1)/n · payload, so an all-gather / reduce-scatter (half the wire
    bytes) folds in as payload/2.  Ops with zero bytes are dropped; an op
    whose axis is missing from ``axis_names`` raises."""
    axis_of = dict(AXIS_OF_OP, **(axis_of or {}))
    by_kind = getattr(profile, "bytes_by_kind", profile)
    ring = {}
    a2a = {}
    for op, b in by_kind.items():
        if op not in axis_of:
            raise ValueError(f"unknown collective kind {op!r}; "
                             f"options: {sorted(AXIS_OF_OP)}")
        if b == 0:
            continue
        axis = axis_of[op]
        if axis not in axis_names:
            raise ValueError(f"profile has {op} bytes but the mesh has no "
                             f"{axis!r} axis (axes: {axis_names})")
        if op in RING_OPS:
            # ring kind = all-reduce accounting (2(n-1)/n); scale other
            # ring ops by their wire-byte ratio (n-independent)
            ring[axis] = ring.get(axis, 0.0) + b * (
                bytes_on_wire(op, 1.0, 2) / bytes_on_wire("all-reduce", 1.0, 2))
        elif op in SPREAD_OPS:
            a2a[axis] = a2a.get(axis, 0.0) + b
    out = {}
    for axis, payload in ring.items():
        out[axis] = ("ring", payload)
    for axis, payload in a2a.items():
        if axis in out:
            raise ValueError(f"axis {axis!r} carries both ring and "
                             f"all-to-all traffic; remap with axis_of")
        out[axis] = ("all_to_all", payload)
    return out


def collective_traffic(mesh_shape, axis_names, bytes_by_axis: dict):
    """Chip-to-chip traffic for one step.

    bytes_by_axis: {axis: (kind, bytes_global)} with kind in
    {'ring', 'all_to_all'}; 'ring' models all-reduce/all-gather/reduce-
    scatter (2(n-1)/n of the payload between ring neighbours, the
    all-reduce wire accounting of fabric.collectives), 'all_to_all'
    models MoE dispatch (payload/n between every ordered pair in the
    group).  Returns (src_chip, dst_chip, bytes) arrays.
    """
    n_chips = int(np.prod(mesh_shape))
    coords = np.stack(np.unravel_index(np.arange(n_chips), mesh_shape), 1)
    srcs, dsts, byts = [], [], []
    for axis, (kind, payload) in bytes_by_axis.items():
        ax = axis_names.index(axis)
        n = mesh_shape[ax]
        if n == 1:
            continue
        nxt = coords.copy()
        if kind == "ring":
            nxt[:, ax] = (nxt[:, ax] + 1) % n
            dst = np.ravel_multi_index(nxt.T, mesh_shape)
            per = bytes_on_wire("all-reduce", payload, n)
            srcs.append(np.arange(n_chips)); dsts.append(dst)
            byts.append(np.full(n_chips, per))
        elif kind == "all_to_all":
            for shift in range(1, n):
                nxt = coords.copy()
                nxt[:, ax] = (nxt[:, ax] + shift) % n
                dst = np.ravel_multi_index(nxt.T, mesh_shape)
                srcs.append(np.arange(n_chips)); dsts.append(dst)
                byts.append(np.full(n_chips, payload / n))
        else:
            raise ValueError(kind)
    if not srcs:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0)
    return (np.concatenate(srcs), np.concatenate(dsts), np.concatenate(byts))


def _router_demand(n: int, router_of: np.ndarray, traffic) -> np.ndarray:
    """Aggregate chip-to-chip traffic to a router-level (N, N) demand
    matrix; same-router bytes land on the diagonal and are zeroed (local
    to the router's terminals, never on the fabric)."""
    src, dst, byts = traffic
    d = np.zeros((n, n))
    np.add.at(d, (router_of[src], router_of[dst]), byts)
    np.fill_diagonal(d, 0.0)
    return d


def placement_demand(profile, placement: Placement, axis_of=None) -> np.ndarray:
    """Compile (StepProfile, Placement) into the router-level (N, N)
    demand matrix of one training step — the object the whole routing
    stack consumes.

    ``profile`` is a fabric.planner.StepProfile (or anything with
    ``bytes_by_kind``), or directly a ``{axis: (kind, bytes)}`` schedule
    as taken by :func:`collective_traffic`.  The matrix is in BYTES per
    step; ``saturation_report(g, placement_demand(...), routing=...)``
    normalizes it (busiest router injects one unit) and reports theta in
    Eq. 1's link-equivalent units."""
    schedule = (profile if isinstance(profile, dict)
                else schedule_from_profile(profile, placement.axis_names,
                                           axis_of))
    traffic = collective_traffic(placement.mesh_shape, placement.axis_names,
                                 schedule)
    return _router_demand(placement.graph.n, placement.router_of, traffic)


def chip_wire_bytes(profile, mesh_shape, axis_names, axis_of=None) -> float:
    """Bytes ONE chip puts on the wire per step under the schedule —
    identical for every chip and independent of placement, which makes it
    the right normalizer for placement theta (below)."""
    schedule = (profile if isinstance(profile, dict)
                else schedule_from_profile(profile, tuple(axis_names),
                                           axis_of))
    total = 0.0
    for axis, (kind, payload) in schedule.items():
        n = mesh_shape[axis_names.index(axis)]
        op = "all-reduce" if kind == "ring" else "all-to-all"
        total += bytes_on_wire(op, payload, n)
    return total


def placement_report(placement: Placement, profile, routing="ugal",
                     engine: str | None = None, axis_of=None, faults=None,
                     device=None):
    """Saturation analysis of one (profile, placement) pair under one
    routing model, as a repro_torch.core.traffic ``SaturationReport``.

    The demand is normalized so the busiest CHIP injects one unit
    (:func:`chip_wire_bytes` — a placement-invariant constant), NOT the
    busiest router: theta = 1/max_load is then the fraction of one
    link's bandwidth every chip can sustainably inject, comparable
    across strategies AND fabrics in Eq. 1's link-equivalent units.
    (Row normalization would rescale each layout by its own peak router
    and erase exactly the locality differences placement search is
    after.)  Raises ValueError when every byte stays router-local (the
    fabric is idle — theta is unbounded).

    ``faults`` (a repro_torch.core.faults.FaultSet) evaluates the same
    per-chip-normalized demand on the degraded fabric — the pristine
    busiest-chip unit is kept, so degraded placement theta is directly
    comparable to pristine.  A fault that kills an occupied router drops
    that router's demand with it (the job has lost those chips)."""
    from ..core.traffic import SaturationReport
    device = resolve_device(device)
    g = placement.graph
    demand = placement_demand(profile, placement, axis_of)
    per_chip = chip_wire_bytes(profile, placement.mesh_shape,
                               placement.axis_names, axis_of)
    if per_chip == 0.0 or not demand.any():
        raise ValueError("placement demand is all router-local "
                         "(theta unbounded); nothing to route")
    norm = demand / per_chip
    label = None
    if faults is not None and not faults.empty:
        label = faults.label
        norm = faults.restrict_demand(g, norm)
        if not norm.any():
            raise ValueError("faults removed every inter-router byte of "
                             "the placement")
        active = faults.restrict_active(g, None)
        g = faults.apply(g)
    else:
        active = np.arange(g.n)
    model = make_routing(routing)
    res = model.evaluate(g, norm, active, engine, device)
    mx = float(res.loads.max())
    mean = float(res.loads.mean())
    return SaturationReport(
        pattern=f"placement({'x'.join(map(str, placement.mesh_shape))})",
        routing=model.name, theta=1.0 / mx, u=mean / mx, max_load=mx,
        mean_load=mean, kbar_eff=res.kbar_eff, diameter=int(res.diameter),
        total_demand=float(norm.sum()), loads=res.loads, alpha=res.alpha,
        faults=label)


def link_loads(p: Placement, traffic, routing="minimal",
               engine: str | None = None, device=None) -> dict:
    """Per-arc load of chip-to-chip traffic under a registered routing
    model: the traffic is aggregated to a router demand matrix
    (:func:`_router_demand`) and routed by repro_torch.core.routing.
    Under ``"minimal"`` this is the equal-split shortest-path accounting,
    which coincides arc by arc with a per-hop ECMP split on the paper's
    diameter-2 fabrics (not on dragonfly, whose shortest-path DAGs are
    unbalanced; the byte-hops agree everywhere)."""
    device = resolve_device(device)
    g = p.graph
    demand = _router_demand(g.n, p.router_of, traffic)
    if not demand.any():  # every byte stays router-local
        zeros = np.zeros(len(g.indices))
        return {"loads": zeros, "max": 0.0, "mean": 0.0, "kbar_eff": 0.0}
    res = make_routing(routing).evaluate(g, demand, np.arange(g.n), engine,
                                         device)
    return {"loads": res.loads, "max": float(res.loads.max()),
            "mean": float(res.loads.mean()), "kbar_eff": res.kbar_eff}


# ---------------------------------------------------------------------------
# Strategy registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlacementStrategy:
    """A named chip->router assignment recipe.

    ``assign(g, mesh_shape, axis_names, delta0, seed=..., schedule=...,
    routing=..., engine=..., device=...)`` returns the (n_chips,) router
    index array; strategies that don't score traffic ignore the trailing
    keywords."""

    name: str
    assign: Callable[..., np.ndarray] = field(repr=False)
    description: str = ""


PLACEMENT_STRATEGIES: dict[str, Callable[..., PlacementStrategy]] = {}


def register_placement(name: str):
    """Register a strategy factory: ``fn(*args) -> PlacementStrategy``."""

    def deco(fn):
        PLACEMENT_STRATEGIES[name] = fn
        return fn

    return deco


def make_placement_strategy(spec) -> PlacementStrategy:
    """Build a strategy from a registry name with optional arguments
    (``"group"``, ``"greedy_swap(120)"``); passes PlacementStrategy
    instances through."""
    if isinstance(spec, PlacementStrategy):
        return spec
    return parse_spec(spec, PLACEMENT_STRATEGIES, "placement strategy")


def _model_axis(axis_names) -> int:
    """The axis whose groups exchange all-to-all; falls back to the last
    axis for meshes without a named model axis."""
    return (axis_names.index("model") if "model" in axis_names
            else len(axis_names) - 1)


def _model_major_order(mesh_shape, axis_names) -> np.ndarray:
    """Chip ids reordered so each model-axis group is contiguous."""
    idx = np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape)
    return np.moveaxis(idx, _model_axis(axis_names), -1).reshape(-1)


def _assign_slots(slots: np.ndarray,
                  chip_order: np.ndarray | None = None) -> np.ndarray:
    """Deal an explicit router-slot sequence to chips (in chip_order,
    default chip-major)."""
    slots = np.asarray(slots, dtype=np.int64)
    if chip_order is None:
        return slots
    router_of = np.empty(len(slots), dtype=np.int64)
    router_of[chip_order] = slots
    return router_of


def _fill(router_order: np.ndarray, n_chips: int, delta0: int,
          chip_order: np.ndarray | None = None) -> np.ndarray:
    """Deal delta0 slots per router (in router_order) to chips (in
    chip_order, default chip-major)."""
    return _assign_slots(np.repeat(router_order, delta0)[:n_chips],
                         chip_order)


@register_placement("linear")
def _linear() -> PlacementStrategy:
    def assign(g, mesh_shape, axis_names, delta0, **kw):
        return _fill(np.arange(g.n), int(np.prod(mesh_shape)), delta0)

    return PlacementStrategy("linear", assign,
                             "chips fill routers in index order")


@register_placement("group")
def _group() -> PlacementStrategy:
    # pack each model-axis group contiguously: chips that talk the most
    # (TP/EP collectives) share a router/electrical group
    def assign(g, mesh_shape, axis_names, delta0, **kw):
        return _fill(np.arange(g.n), int(np.prod(mesh_shape)), delta0,
                     _model_major_order(mesh_shape, axis_names))

    return PlacementStrategy("group", assign,
                             "model-axis groups packed onto consecutive routers")


@register_placement("random")
def _random() -> PlacementStrategy:
    def assign(g, mesh_shape, axis_names, delta0, seed=0, **kw):
        rng = np.random.default_rng(seed)
        return rng.permutation(
            np.repeat(np.arange(g.n), delta0))[:int(np.prod(mesh_shape))]

    return PlacementStrategy("random", assign, "seeded shuffle baseline")


def _orbit_router_order(g: Graph) -> np.ndarray:
    """Routers sorted leaf-columns-first, then by automorphism vertex
    orbit, then by index; graphs without known generators keep index
    order (the strategy degenerates to group)."""
    from ..core.orbits import orbit_info
    info = orbit_info(g)
    orbit = (info.vertex_orbit if info is not None
             else np.zeros(g.n, dtype=np.int64))
    leaf = g.meta.get("leaf_mask")
    spine_first = (np.zeros(g.n, dtype=np.int64) if leaf is None
                   else (~np.asarray(leaf, dtype=bool)).astype(np.int64))
    return np.lexsort((np.arange(g.n), orbit, spine_first))


@register_placement("orbit")
def _orbit() -> PlacementStrategy:
    def assign(g, mesh_shape, axis_names, delta0, **kw):
        return _fill(_orbit_router_order(g), int(np.prod(mesh_shape)),
                     delta0, _model_major_order(mesh_shape, axis_names))

    return PlacementStrategy(
        "orbit", assign,
        "group packing onto an automorphism-orbit-sorted router order "
        "(leaf columns first); orbit-spanning groups hit the orbit shortcut")


def _swap_descent(p: Placement, traffic, iters: int, seed: int,
                  routing, engine, device
                  ) -> tuple[Placement, float, list[float]]:
    """Pairwise-swap descent on max arc load.  Deterministic for a given
    seed (the candidate swap sequence is drawn up front) and monotone:
    a swap is kept only when it strictly lowers the objective."""
    model = make_routing(routing)
    g = p.graph
    active = np.arange(g.n)

    def objective(router_of) -> float:
        d = _router_demand(g.n, router_of, traffic)
        if not d.any():
            return 0.0
        return float(model.evaluate(g, d, active, engine,
                                    device).loads.max())

    cur = p.router_of.copy()
    with obs.span("placement.greedy_swap", iters=int(iters),
                  chips=int(p.n_chips), routing=str(routing)) as sp:
        evals = obs.counter("placement.swap_evals")
        accepts = obs.counter("placement.swap_accepted")
        best = objective(cur)
        history = [best]
        pairs = np.random.default_rng(seed).integers(0, p.n_chips,
                                                     (iters, 2))
        for i, j in pairs:
            if cur[i] == cur[j] or best == 0.0:
                history.append(best)
                continue
            cand = cur.copy()
            cand[i], cand[j] = cand[j], cand[i]
            evals.add(1.0)
            m = objective(cand)
            if m < best:
                accepts.add(1.0)
                best, cur = m, cand
            history.append(best)
        sp.set(best=best)
    return (Placement(g, p.mesh_shape, p.axis_names, cur), best, history)


@register_placement("greedy_swap")
def _greedy_swap(iters: int = 200, start: str = "group") -> PlacementStrategy:
    def assign(g, mesh_shape, axis_names, delta0, seed=0, schedule=None,
               routing="minimal", engine=None, device=None, **kw):
        if schedule is None:
            raise ValueError("greedy_swap needs the schedule it descends "
                             "on; pass schedule= to place_mesh")
        base = make_placement_strategy(start).assign(
            g, mesh_shape, axis_names, delta0, seed=seed, schedule=schedule,
            routing=routing, engine=engine, device=device)
        p0 = Placement(g, tuple(mesh_shape), tuple(axis_names), base)
        traffic = collective_traffic(mesh_shape, axis_names, schedule)
        p, _, _ = _swap_descent(p0, traffic, iters, seed, routing, engine,
                                resolve_device(device))
        return p.router_of

    return PlacementStrategy(f"greedy_swap({iters},{start})", assign,
                             "pairwise-swap descent on max arc load")


def place_mesh(g: Graph, mesh_shape, axis_names, terminals_per_router: int,
               strategy="linear", seed: int = 0, schedule=None,
               routing="minimal", engine: str | None = None,
               device=None) -> Placement:
    """Assign a (pod, data, model)-shaped chip mesh to routers via a
    registered strategy.  ``schedule``/``routing``/``engine``/``device``
    feed the traffic-scoring strategies (greedy_swap); the geometric
    strategies ignore them."""
    device = resolve_device(device)
    n_chips = int(np.prod(mesh_shape))
    capacity = g.n * terminals_per_router
    if n_chips > capacity:
        raise ValueError(f"{n_chips} chips > {capacity} terminals "
                         f"({g.n} routers x {terminals_per_router})")
    strat = make_placement_strategy(strategy)
    router_of = np.asarray(
        strat.assign(g, tuple(mesh_shape), tuple(axis_names),
                     terminals_per_router, seed=seed, schedule=schedule,
                     routing=routing, engine=engine, device=device),
        dtype=np.int64)
    if (np.bincount(router_of, minlength=g.n) > terminals_per_router).any():
        raise ValueError(f"strategy {strat.name!r} oversubscribed a router "
                         f"beyond {terminals_per_router} terminals")
    return Placement(g, tuple(mesh_shape), tuple(axis_names), router_of)


# ---------------------------------------------------------------------------
# Search and comparison
# ---------------------------------------------------------------------------


def greedy_improve(p: Placement, traffic, iters: int = 200, seed: int = 0,
                   routing="minimal", engine: str | None = None,
                   return_history: bool = False, device=None):
    """Pairwise-swap descent on max arc load under ``routing``.
    Seed-deterministic (the swap sequence is pre-drawn) with a monotone
    non-increasing objective; ``return_history=True`` also returns the
    per-iteration best objective."""
    placed, best, history = _swap_descent(p, traffic, iters, seed, routing,
                                          engine, resolve_device(device))
    if return_history:
        return placed, best, history
    return placed, best


DEFAULT_STRATEGIES = ("linear", "group", "random", "orbit")


def _strategy_row(g, placement, schedule, routing, engine, device) -> dict:
    per_chip = chip_wire_bytes(schedule, placement.mesh_shape,
                               placement.axis_names)
    try:
        rep = placement_report(placement, schedule, routing=routing,
                               engine=engine, device=device)
    except ValueError:  # all traffic router-local: the fabric is idle
        return {"theta": float("inf"), "u": 1.0, "max_load": 0.0,
                "kbar_eff": 0.0, "alpha": None, "max_bytes": 0.0,
                "mean_bytes": 0.0}
    return {"theta": rep.theta, "u": rep.u, "max_load": rep.max_load,
            "kbar_eff": rep.kbar_eff, "alpha": rep.alpha,
            "max_bytes": rep.max_load * per_chip,
            "mean_bytes": rep.mean_load * per_chip}


def evaluate_placements(g: Graph, mesh_shape, axis_names, delta0: int,
                        profile, strategies=DEFAULT_STRATEGIES,
                        routing="ugal", seed: int = 0,
                        engine: str | None = None, device=None) -> dict:
    """Compare placement strategies on one fabric; returns
    ``{strategy: {theta, u, max_load, kbar_eff, alpha, max_bytes,
    mean_bytes}}`` with theta in Eq. 1's link-equivalent units — demand
    normalized so the busiest CHIP injects one unit (see
    :func:`placement_report`), comparable across strategies and fabrics,
    unlike raw max-bytes.  ``max_bytes`` keeps the raw per-step
    busiest-link bytes for capacity planning."""
    device = resolve_device(device)
    schedule = (profile if isinstance(profile, dict)
                else schedule_from_profile(profile, tuple(axis_names)))
    out = {}
    for spec in strategies:
        strat = make_placement_strategy(spec)
        p = place_mesh(g, mesh_shape, axis_names, delta0, strat, seed=seed,
                       schedule=schedule, routing=routing, engine=engine,
                       device=device)
        out[strat.name] = _strategy_row(g, p, schedule, routing, engine,
                                        device)
    return out


def placement_search(g: Graph, mesh_shape, axis_names, delta0: int, profile,
                     strategies=DEFAULT_STRATEGIES + ("greedy_swap",),
                     routing="ugal", seed: int = 0,
                     engine: str | None = None, adversary: bool = False,
                     n_random: int = 4, device=None) -> dict:
    """Strategy search scored by theta under ``routing`` (default ugal —
    the routing the fabric actually runs), optionally cross-checked by
    the worst case repro_torch.core.adversary finds over the routers the
    job occupies (``adv_theta``: how robust the occupied set is to
    hostile tenant traffic).  Returns ``{"rows": {strategy: row}, "best":
    name, "placements": {strategy: Placement}}`` with best = argmax theta
    (ties broken by adv_theta when searched)."""
    device = resolve_device(device)
    schedule = (profile if isinstance(profile, dict)
                else schedule_from_profile(profile, tuple(axis_names)))
    rows, placements = {}, {}
    adv_cache: dict[bytes, tuple] = {}  # strategies often share occupied sets
    for spec in strategies:
        strat = make_placement_strategy(spec)
        p = place_mesh(g, mesh_shape, axis_names, delta0, strat, seed=seed,
                       schedule=schedule, routing=routing, engine=engine,
                       device=device)
        row = _strategy_row(g, p, schedule, routing, engine, device)
        if adversary:
            from ..core.adversary import worst_case
            key = p.occupied.tobytes()
            if key not in adv_cache:
                adv = worst_case(g, routing, n_random=n_random, seed=seed,
                                 engine=engine, targets_mask=p.occupied,
                                 device=device)
                adv_cache[key] = (adv.worst_theta, adv.worst_pattern)
            row["adv_theta"], row["adv_pattern"] = adv_cache[key]
        rows[strat.name] = row
        placements[strat.name] = p
    best = max(rows, key=lambda k: (rows[k]["theta"],
                                    rows[k].get("adv_theta", 0.0)))
    return {"rows": rows, "best": best, "placements": placements}
