"""The Section-5 selector, operationalized: given a training job's per-step
collective profile (straight from the dry-run JSONs) and a chip budget,
evaluate candidate fabrics on (a) the paper's $-and-Watts model and (b)
per-step collective time from the saturation model — the full loop from
'compiled XLA program' to 'which network should the cluster buy'.

With a mesh shape, the buy loop goes placement-aware: each candidate
places the job via a registered placement strategy (fabric.placement),
compiles the (profile, placement) pair into a router-level demand matrix,
and prices the step off the busiest link under the routing the fabric
actually runs (default ugal) — the quantity Eq. 1's uniform closed form
approximates.  ``fragmentation_sweep`` compares multi-tenant layouts
(packed vs interleaved vs chip-major linear) at pod scale under optional
background adversary traffic.

The port's counterpart of ``repro.fabric.planner``: every utilization,
resilience sweep and placement evaluation runs on ``device``, the card
unless ``device="cpu"`` is passed (a fabric's own device where a
function takes a fabric); the cost model and the layout stay on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._device import resolve_device
from ..core import (DirectNetworkSpec, cable_split, dollars_per_node,
                    electrical_groups, utilization, watts_per_node)
from ..core.reference import dragonfly_canonical_stats
from ..core.routing import make_routing
from .collectives import PER_HOP_LATENCY_S, collective_time
from .model import FabricModel
from .placement import (Placement, _assign_slots, _model_major_order,
                        chip_wire_bytes, placement_demand,
                        schedule_from_profile)

__all__ = ["FabricCandidate", "candidate_fabrics", "plan", "StepProfile",
           "placement_step_seconds", "fragmentation_sweep"]


@dataclass
class StepProfile:
    """Per-step per-device collective bytes by kind (from the dry-run)."""
    bytes_by_kind: dict
    steps_per_run: int = 1

    @classmethod
    def from_dryrun(cls, record: dict) -> "StepProfile":
        coll = dict(record.get("collective_bytes_per_device", {}))
        coll.pop("total", None)
        return cls(bytes_by_kind=coll)


def placement_step_seconds(fabric: FabricModel, profile, placement: Placement,
                           routing="ugal", engine: str | None = None
                           ) -> float:
    """Per-step collective seconds of a PLACED job: the (profile,
    placement) demand matrix is routed under ``routing`` and the busiest
    link's bytes serialize the step (per-arc capacity =
    ``link_bytes_per_s``), plus one demand-weighted hop-latency term per
    collective phase — the placement-aware replacement for the uniform
    Eq. 1 pricing of ``FabricCandidate.step_comm_seconds``.  Runs on the
    fabric's device."""
    demand = placement_demand(profile, placement)
    by_kind = getattr(profile, "bytes_by_kind", profile)
    n_ops = sum(1 for b in by_kind.values()
                if (b[1] if isinstance(b, tuple) else b))
    if not demand.any():  # every byte stays router-local
        return 0.0
    res = make_routing(routing).evaluate(
        placement.graph, demand, np.arange(placement.graph.n), engine,
        fabric.device)
    return (float(res.loads.max()) / fabric.link_bytes_per_s
            + n_ops * res.kbar_eff * PER_HOP_LATENCY_S)


@dataclass
class FabricCandidate:
    fabric: FabricModel
    terminals: int
    radix: int
    dollars_per_node: float
    watts_per_node: float

    def step_comm_seconds(self, profile: StepProfile, placement=None,
                          routing="minimal") -> float:
        """Uniform Eq. 1 pricing by default; with a Placement, the
        placement-aware busiest-link pricing of
        :func:`placement_step_seconds` under ``routing``."""
        if placement is not None:
            return placement_step_seconds(self.fabric, profile, placement,
                                          routing=routing)
        n = self.terminals
        return sum(collective_time(self.fabric, kind, b, n).total_s
                   for kind, b in profile.bytes_by_kind.items())


def _mk_candidate(g, delta0, name=None, device=None) -> FabricCandidate:
    device = resolve_device(device)
    if g.meta.get("family") == "dragonfly":
        kbar, u = dragonfly_canonical_stats(g.meta["h"])
    else:
        sources = None
        if g.n > 3000:
            sources = np.random.default_rng(0).choice(g.n, 256, replace=False)
        rep = utilization(g, sources=sources, device=device)
        kbar, u = rep.kbar, rep.u
    fab = FabricModel(g, terminals_per_router=delta0, kbar=kbar, u=u,
                      name=name or g.name, device=device)
    labels = electrical_groups(g, delta0)
    ne, no = cable_split(g, labels)
    leaf = g.meta.get("leaf_mask")
    n_leaf = int(leaf.sum()) if leaf is not None else g.n
    spec = DirectNetworkSpec(
        name=fab.name, terminals=int(round(n_leaf * delta0)),
        radix=int(round(g.max_degree + delta0)),
        routers=g.n, degree=g.max_degree, terminals_per_router=delta0,
        kbar=kbar, u=u, electrical_cables=ne, optical_cables=no)
    return FabricCandidate(fab, spec.terminals, spec.radix,
                           dollars_per_node(spec), watts_per_node(spec))


def candidate_fabrics(min_terminals: int, max_radix: int = 64, device=None):
    """Instantiate the main families at the smallest size covering the
    terminal count within the radix budget."""
    from ..core import (demi_pn_graph, dragonfly_graph, hamming_graph,
                        mms_graph, pn_graph)
    from ..core.gf import is_prime_power
    device = resolve_device(device)
    out = []

    def try_family(builder, params, delta0_of, name):
        for p in params:
            try:
                g = builder(p)
            except Exception:
                continue
            d0 = delta0_of(g)
            if g.max_degree + d0 > max_radix:
                continue
            if g.n * d0 >= min_terminals:
                out.append(_mk_candidate(g, d0, name=f"{name}({p})",
                                         device=device))
                return

    pps = [q for q in range(3, 80) if is_prime_power(q)]
    try_family(demi_pn_graph, pps, lambda g: (g.meta["q"] + 1) // 2, "demi-PN")
    try_family(pn_graph, pps, lambda g: max(1, round(2 * (g.meta["q"] + 1) / 5)), "PN")
    try_family(mms_graph, [q for q in pps if q % 4 != 2],
               lambda g: max(1, round(4 / 9 * g.max_degree)), "SF-MMS")
    try_family(dragonfly_graph, list(range(2, 17)), lambda g: g.meta["h"],
               "dragonfly")
    try_family(hamming_graph, list(range(4, 40)), lambda g: g.meta["side"],
               "Hamming2D")
    return out


# Beyond this router count a candidate's dense placement demand matrix
# stops being the right tool (FabricModel.PATTERN_MAX_N analogue for the
# buy loop); such candidates keep their uniform Eq. 1 pricing.
PLACEMENT_MAX_N = 2048


def plan(profile: StepProfile, min_terminals: int, max_radix: int = 64,
         mesh_shape=None, axis_names=("model", "data"),
         placement_strategy="group", routing="ugal", seed: int = 0,
         resilience_k: int = 0, resilience_trials: int = 4,
         resilience_seed: int = 0, device=None):
    """Rank fabrics by step-communication time and report $/W; returns list
    of dict rows sorted by comm time.

    With ``mesh_shape``, each candidate that can host the job (and has at
    most ``PLACEMENT_MAX_N`` routers) is additionally priced
    placement-aware: the job is placed via ``placement_strategy``, its
    demand matrix routed under ``routing``, and ``placed_comm_ms`` (the
    busiest-link step time) drives the ranking — per-step collective time
    under the congestion the actual schedule causes, not the uniform
    closed form.

    With ``resilience_k > 0``, each candidate with at most
    ``PLACEMENT_MAX_N`` routers also gets a graceful-degradation score:
    ``resilience_theta`` is the WORST uniform-traffic theta over
    ``resilience_trials`` seeded draws of ``resilience_k`` link failures
    (connectivity-preserving, routed under ``routing``), and
    ``resilience_frac`` that worst theta as a fraction of the pristine
    value — how much of the fabric's throughput guarantee survives the
    failure scenario.  Ranking stays by comm time; resilience is a
    reported trade-off column.  Every sweep runs on ``device``."""
    return _ranked(_plan_rows(
        profile, min_terminals, max_radix, mesh_shape, axis_names,
        placement_strategy, routing, seed, resilience_k, resilience_trials,
        resilience_seed, device), placed=mesh_shape is not None)


# plan's columns and the digits it rounds them to
_DIGITS = {"kbar": 3, "u": 3, "kbar_over_u": 3, "step_comm_ms": 3,
           "usd_per_node": 2, "watts_per_node": 2, "resilience_theta": 4,
           "resilience_frac": 4, "placed_comm_ms": 3}


def _ranked(raw_rows, placed: bool) -> list[dict]:
    """plan's rows from :func:`_plan_rows`: rounded, and sorted by step
    time."""
    rows = [{k: round(v, _DIGITS[k]) if k in _DIGITS else v
             for k, v in raw.items()} for raw in raw_rows]
    # placed (congestion-aware) and uniform step times are differently
    # modeled quantities: rank placeable candidates first among
    # themselves, un-placeable ones after (by their uniform figure)
    return sorted(rows, key=lambda r: (("placed_comm_ms" not in r)
                                       if placed else False,
                                       r.get("placed_comm_ms",
                                             r["step_comm_ms"])))


def _plan_rows(profile, min_terminals, max_radix, mesh_shape, axis_names,
               placement_strategy, routing, seed, resilience_k,
               resilience_trials, resilience_seed, device) -> list[dict]:
    """plan's row of each candidate, in candidate order, before its
    rounding (every sweep runs on ``device``)."""
    device = resolve_device(device)
    rows = []
    for cand in candidate_fabrics(min_terminals, max_radix, device=device):
        t = cand.step_comm_seconds(profile)
        row = {
            "fabric": cand.fabric.name,
            "terminals": cand.terminals,
            "radix": cand.radix,
            "kbar": cand.fabric.kbar,
            "u": cand.fabric.u,
            "kbar_over_u": cand.fabric.kbar / cand.fabric.u,
            "step_comm_ms": t * 1e3,
            "usd_per_node": cand.dollars_per_node,
            "watts_per_node": cand.watts_per_node,
        }
        if resilience_k > 0 and cand.fabric.graph.n <= PLACEMENT_MAX_N:
            from ..core.faults import degradation_sweep
            sweep = degradation_sweep(
                cand.fabric.graph, k_failures=(int(resilience_k),),
                trials=resilience_trials, pattern="uniform",
                routing=routing, kind="links", seed=resilience_seed,
                device=device)
            worst = float(sweep.worst[0])
            row["resilience_k"] = int(resilience_k)
            row["resilience_theta"] = worst
            row["resilience_frac"] = worst / sweep.pristine_theta
        if mesh_shape is not None:
            n_chips = int(np.prod(mesh_shape))
            g = cand.fabric.graph
            d0 = int(cand.fabric.terminals_per_router)
            if g.n <= PLACEMENT_MAX_N and n_chips <= g.n * d0:
                schedule = schedule_from_profile(profile, tuple(axis_names))
                p = cand.fabric.place(mesh_shape, axis_names,
                                      strategy=placement_strategy, seed=seed,
                                      schedule=schedule, routing=routing)
                placed = placement_step_seconds(cand.fabric, profile, p,
                                                routing=routing)
                row["placed_comm_ms"] = placed * 1e3
                row["placement_strategy"] = placement_strategy
                row["placement_routing"] = routing
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Fragmentation at pod scale: multi-tenant layout comparison
# ---------------------------------------------------------------------------

FRAGMENTATION_LAYOUTS = ("packed", "interleaved", "linear")


def _layout_slots(g, jobs, delta0: int, layout: str) -> list[np.ndarray]:
    """Router-slot sequence per job.  ``packed``/``linear`` hand each job
    a contiguous slab of router slots; ``interleaved`` deals slots
    round-robin across jobs — the fragmented schedule where tenants split
    each router's terminals and every model group is forced off-router."""
    chips = [int(np.prod(mesh)) for mesh, _, _ in jobs]
    capacity = g.n * delta0
    if sum(chips) > capacity:
        raise ValueError(f"{sum(chips)} chips > {capacity} terminals "
                         f"({g.n} routers x {delta0})")
    slot_router = np.repeat(np.arange(g.n), delta0)
    if layout in ("packed", "linear"):
        cuts = np.cumsum([0] + chips)
        return [slot_router[cuts[j]:cuts[j + 1]] for j in range(len(jobs))]
    if layout == "interleaved":
        j_count = len(jobs)
        return [slot_router[j::j_count][:chips[j]] for j in range(j_count)]
    raise ValueError(f"unknown layout {layout!r}; "
                     f"options: {FRAGMENTATION_LAYOUTS}")


def fragmentation_demand(g, jobs, delta0: int, layout: str) -> np.ndarray:
    """Combined router-level demand of several co-tenant jobs under one
    layout.  ``jobs`` is an iterable of (mesh_shape, axis_names, profile);
    ``packed``/``interleaved`` fill each job's slots model-group-major,
    ``linear`` chip-major (the naive scheduler both placement strategies
    beat)."""
    demand = np.zeros((g.n, g.n))
    for (mesh, axes, prof), slots in zip(jobs,
                                         _layout_slots(g, jobs, delta0,
                                                       layout)):
        order = (None if layout == "linear"
                 else _model_major_order(mesh, tuple(axes)))
        p = Placement(g, tuple(mesh), tuple(axes), _assign_slots(slots, order))
        demand += placement_demand(prof, p)
    return demand


def fragmentation_sweep(g, jobs, delta0: int,
                        layouts=FRAGMENTATION_LAYOUTS, routing="ugal",
                        background=None, background_scale: float = 1.0,
                        engine: str | None = None, device=None) -> dict:
    """Score multi-tenant layouts at pod scale: theta of the combined
    (jobs + optional background pattern) demand per layout under one
    routing model.  ``background`` is any traffic-pattern spec (e.g.
    ``"tornado"`` — a hostile co-tenant), scaled so its busiest source
    injects ``background_scale``x the jobs' busiest per-chip wire bytes.
    theta is normalized by the layout-INVARIANT busiest per-chip wire
    bytes (fabric.placement.chip_wire_bytes), so layouts compare by
    actual step throughput rather than each being rescaled by its own
    peak router.  Returns ``{"layouts": {layout: row}, "best": name}``;
    packed placement keeping TP/EP groups on whole routers dominates the
    fragmented interleaved schedule wherever group locality matters."""
    from ..core.traffic import make_pattern
    device = resolve_device(device)
    jobs = list(jobs)
    per_chip = max(chip_wire_bytes(prof, tuple(mesh), tuple(axes))
                   for mesh, axes, prof in jobs)
    if per_chip == 0.0:
        raise ValueError("no job puts bytes on the wire")
    bg = None
    if background is not None:
        bg = make_pattern(background).demand(g)
        bg *= background_scale * per_chip / float(bg.sum(axis=1).max())
    rows = {}
    model = make_routing(routing)
    active = np.arange(g.n)
    for layout in layouts:
        demand = fragmentation_demand(g, jobs, delta0, layout)
        if bg is not None:
            demand = demand + bg
        res = model.evaluate(g, demand / per_chip, active, engine, device)
        mx = float(res.loads.max())
        rows[layout] = {"theta": 1.0 / mx, "u": float(res.loads.mean()) / mx,
                        "max_load": mx, "kbar_eff": res.kbar_eff,
                        "alpha": res.alpha}
    return {"layouts": rows,
            "best": max(rows, key=lambda k: rows[k]["theta"])}
