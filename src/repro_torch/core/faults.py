"""Fault injection and degraded-fabric analysis: what survives of theta
when links and routers die.

The port's counterpart of ``repro.core.faults``.  The fault objects and
their constructors are numpy on the host, as in the reference; every
theta runs through the port's routing models and arc-load engines
(``engine`` ``fused`` / ``dense`` / ``auto``) on the card unless the
caller passes ``device="cpu"``.

``FaultSet``
    An immutable set of down links (undirected endpoint pairs) and down
    routers.  ``apply(g)`` compiles a pristine :class:`Graph` into the
    degraded subgraph: link faults remove edges in place (N and the
    family meta kept, so traffic patterns stay exact), router faults
    remove the vertex and relabel survivors compactly (family meta
    dropped; ``meta["fault_survivors"]`` maps new ids back).  Both go
    through :meth:`Graph.subgraph`; ``meta["faults"]`` marks the graph.

``random_faults`` / ``targeted_faults``
    Seeded random-k draws (resampled until the degraded graph stays
    connected; the same numpy draws in the same order as the reference,
    so one seed gives the reference's fault sets) and the adversarial
    greedy cut: remove the max-load link or router under a routing
    model, re-evaluating after each cut.

``fault_report``
    Connectivity report of a fault set: component count and sizes,
    surviving active vertices, whether the analytic engines can evaluate
    the degraded graph at all.

``degraded_report``
    The analytic reroute: the pattern is built and normalized on the
    PRISTINE graph (busiest pristine source injects one unit, so
    degraded theta stays comparable to pristine theta), restricted to the
    survivors and evaluated by any registered routing model on the
    degraded graph.  ``saturation_report(g, p, faults=fs)`` delegates
    here.

``degradation_sweep``
    theta-vs-k curves with percentile bands: per trial one seeded
    failure ORDER, each k a prefix of it (nested faults), so every
    trial's curve is monotone whenever theta is.

Under an obs session, as in the reference: ``targeted_faults`` is a
``faults.targeted`` span counting ``faults.targeted_rounds``, and
``degradation_sweep`` a ``faults.degradation_sweep`` span streaming
``Progress("faults.trials")`` records.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import obs
from .._device import resolve_device
from .graph import Graph, bfs_distances
from .routing import make_routing

__all__ = [
    "FaultSet", "FaultReport", "DegradationSweep", "fault_report",
    "random_faults", "targeted_faults", "degraded_report",
    "degradation_sweep",
]


@dataclass(frozen=True)
class FaultSet:
    """An immutable set of failed components of one graph.

    ``links`` are undirected endpoint pairs (order-insensitive,
    deduplicated); ``routers`` vertex ids.  A link incident to a down
    router is redundant but allowed.  The set is graph-agnostic until
    validated/applied against a specific graph."""

    links: tuple = ()
    routers: tuple = ()

    def __post_init__(self):
        links = tuple(sorted({(min(int(u), int(v)), max(int(u), int(v)))
                              for u, v in self.links}))
        for u, v in links:
            if u == v:
                raise ValueError(f"link fault ({u}, {v}) is a self-loop")
        routers = tuple(sorted({int(r) for r in self.routers}))
        object.__setattr__(self, "links", links)
        object.__setattr__(self, "routers", routers)

    # ---- identity ----
    @property
    def empty(self) -> bool:
        return not self.links and not self.routers

    @property
    def label(self) -> str:
        """Canonical human/cache key, e.g. ``links[0-3,5-9]+routers[2]``."""
        parts = []
        if self.links:
            parts.append("links[" + ",".join(f"{u}-{v}"
                                             for u, v in self.links) + "]")
        if self.routers:
            parts.append("routers[" + ",".join(map(str, self.routers)) + "]")
        return "+".join(parts) if parts else "none"

    # ---- resolution against a graph ----
    def edge_ids(self, g: Graph) -> np.ndarray:
        """Undirected edge ids of the down links; raises if a pair is not
        an edge of ``g``."""
        if not self.links:
            return np.empty(0, dtype=np.int64)
        e = np.sort(g.edges, axis=1)
        packed = e[:, 0] * np.int64(g.n) + e[:, 1]
        order = np.argsort(packed)
        want = np.array([u * g.n + v for u, v in self.links], dtype=np.int64)
        pos = np.searchsorted(packed[order], want)
        bad = (pos >= len(packed)) | (packed[order][np.minimum(
            pos, len(packed) - 1)] != want)
        if bad.any():
            missing = [self.links[i] for i in np.nonzero(bad)[0]]
            raise ValueError(f"link faults {missing} are not edges of "
                             f"{g.name or 'the graph'}")
        return order[pos]

    def router_ids(self, g: Graph) -> np.ndarray:
        rid = np.array(self.routers, dtype=np.int64)
        if rid.size and (rid.min() < 0 or rid.max() >= g.n):
            raise ValueError(f"router fault ids out of range for N={g.n}")
        return rid

    def router_mask(self, g: Graph) -> np.ndarray:
        """(N,) bool: True where the router survives."""
        ok = np.ones(g.n, dtype=bool)
        ok[self.router_ids(g)] = False
        return ok

    def edge_alive(self, g: Graph) -> np.ndarray:
        """(E,) bool over ``g.edges``: True where the undirected edge
        survives (neither failed itself nor incident to a dead router)."""
        alive = np.ones(g.num_edges, dtype=bool)
        alive[self.edge_ids(g)] = False
        rok = self.router_mask(g)
        return alive & rok[g.edges[:, 0]] & rok[g.edges[:, 1]]

    def survivors(self, g: Graph) -> np.ndarray:
        """Old-label ids of surviving routers (identity when no router
        faults)."""
        return np.nonzero(self.router_mask(g))[0]

    # ---- compilation ----
    def apply(self, g: Graph) -> Graph:
        """Compile the degraded graph.  Link-only faults preserve N and
        the family meta (traffic patterns built on the degraded graph
        stay exact); router faults relabel survivors and drop
        family/dims meta (coordinates no longer cover the vertex set).
        ``meta["faults"]`` is set either way: a fault set breaks the
        pristine symmetry that the reference's orbit shortcut uses."""
        if self.empty:
            raise ValueError("empty FaultSet; nothing to apply")
        name = f"{g.name or 'graph'}!{self.label}"
        if not self.routers:
            meta = dict(g.meta)
            meta["faults"] = self.label
            return g.subgraph(edge_mask=self.edge_alive(g), name=name,
                              meta=meta)
        vm = self.router_mask(g)
        if vm.sum() < 2:
            raise ValueError("router faults leave fewer than 2 routers")
        meta = {k: v for k, v in g.meta.items()
                if k not in ("family", "dims", "leaf_mask")}
        meta["faults"] = self.label
        meta["fault_survivors"] = np.nonzero(vm)[0]
        leaf = g.meta.get("leaf_mask")
        if leaf is not None:
            meta["leaf_mask"] = np.asarray(leaf, dtype=bool)[vm]
        return g.subgraph(edge_mask=self.edge_alive(g), vertex_mask=vm,
                          name=name, meta=meta)

    # ---- restriction helpers (pristine-built objects -> degraded) ----
    def restrict_demand(self, g: Graph, demand: np.ndarray) -> np.ndarray:
        """Restrict a pristine (N, N) demand matrix to the survivors —
        dead routers take their rows/columns (their injected and
        addressed traffic) with them; no renormalization, so degraded
        theta stays in the pristine busiest-source units."""
        demand = np.asarray(demand, dtype=np.float64)
        if demand.shape != (g.n, g.n):
            raise ValueError(f"demand is {demand.shape}, graph has N={g.n}")
        if not self.routers:
            return demand.copy()
        surv = self.survivors(g)
        return demand[np.ix_(surv, surv)].copy()

    def restrict_active(self, g: Graph, targets_mask=None) -> np.ndarray:
        """Degraded-label ids of surviving active vertices.
        ``targets_mask`` is a pristine (N,) bool mask (None = all
        vertices); the result indexes the graph ``apply`` returns."""
        if targets_mask is None:
            active = np.ones(g.n, dtype=bool)
        else:
            active = np.asarray(targets_mask, dtype=bool).copy()
        vm = self.router_mask(g)
        new_id = np.cumsum(vm) - 1
        keep = active & vm
        return new_id[np.nonzero(keep)[0]]


@dataclass
class FaultReport:
    """Connectivity/partition report of one (graph, FaultSet)."""

    faults: str
    n_pristine: int
    n_degraded: int
    routers_down: int
    links_down: int            # edges removed beyond the dead routers'
    edges_removed: int         # total undirected edges lost
    n_components: int
    component_sizes: tuple
    connected: bool            # whole degraded graph one component
    active_survivors: int
    active_connected: bool     # surviving active set in one component
    evaluable: bool            # analytic engines can run (connected, >=2)


def fault_report(g: Graph, fs: FaultSet) -> FaultReport:
    """Partition analysis of the degraded graph: what the fault set cut
    off, and whether the analytic engines (which require every vertex
    reachable from the active set) can evaluate it at all."""
    gd = fs.apply(g) if not fs.empty else g
    comp = np.full(gd.n, -1, dtype=np.int64)
    sizes = []
    for start in range(gd.n):
        if comp[start] >= 0:
            continue
        reach = bfs_distances(gd, start) >= 0
        comp[reach] = len(sizes)
        sizes.append(int(reach.sum()))
    leaf = gd.meta.get("leaf_mask")
    act = (np.arange(gd.n) if leaf is None
           else np.nonzero(np.asarray(leaf, dtype=bool))[0])
    act_conn = bool(len(act) > 0 and np.unique(comp[act]).size == 1)
    connected = len(sizes) <= 1
    return FaultReport(
        faults=fs.label, n_pristine=g.n, n_degraded=gd.n,
        routers_down=len(fs.routers), links_down=len(fs.links),
        edges_removed=g.num_edges - gd.num_edges,
        n_components=len(sizes), component_sizes=tuple(sizes),
        connected=connected, active_survivors=int(len(act)),
        active_connected=act_conn,
        evaluable=bool(connected and len(act) >= 2))


# ---------------------------------------------------------------------------
# Fault-set constructors
# ---------------------------------------------------------------------------


def _links_from_edges(g: Graph, edge_ids) -> tuple:
    e = g.edges[np.asarray(edge_ids, dtype=np.int64)]
    return tuple((int(u), int(v)) for u, v in e)


def random_faults(g: Graph, k_links: int = 0, k_routers: int = 0,
                  seed: int = 0, require_connected: bool = True,
                  max_tries: int = 64) -> FaultSet:
    """A seeded uniform draw of ``k_links`` dead edges and ``k_routers``
    dead routers.  With ``require_connected`` (the default) the draw is
    resampled until the degraded graph is connected with at least two
    surviving active vertices — the regime every analytic engine and the
    simulator's masked tables require."""
    k_links, k_routers = int(k_links), int(k_routers)
    if k_links < 0 or k_routers < 0:
        raise ValueError("fault counts must be >= 0")
    if k_links > g.num_edges:
        raise ValueError(f"k_links={k_links} > {g.num_edges} edges")
    if k_routers >= g.n - 1:
        raise ValueError(f"k_routers={k_routers} leaves < 2 of {g.n} routers")
    if k_links == 0 and k_routers == 0:
        return FaultSet()
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), g.n]))
    for _ in range(max_tries):
        eids = rng.choice(g.num_edges, size=k_links, replace=False)
        rids = rng.choice(g.n, size=k_routers, replace=False)
        fs = FaultSet(links=_links_from_edges(g, eids),
                      routers=tuple(int(r) for r in rids))
        if not require_connected:
            return fs
        rep = fault_report(g, fs)
        if rep.evaluable:
            return fs
    raise ValueError(
        f"no connected degraded graph found in {max_tries} draws for "
        f"k_links={k_links}, k_routers={k_routers} on {g.name or 'graph'}")


def targeted_faults(g: Graph, k: int, kind: str = "links",
                    pattern="uniform", routing: str = "minimal",
                    engine: str | None = None,
                    require_connected: bool = True,
                    device=None) -> FaultSet:
    """The adversarial cut: greedily remove the component carrying the
    highest routed load under ``(pattern, routing)``, re-evaluating the
    degraded graph after each removal — k rounds of 'kill the busiest
    link (or router)'.  With ``require_connected`` a removal that would
    disconnect the survivors is skipped for the next-loaded candidate.
    The loads run on ``device``."""
    from .traffic import make_pattern, normalize_demand
    if kind not in ("links", "routers"):
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"options: links, routers")
    k = int(k)
    device = resolve_device(device)
    leaf = g.meta.get("leaf_mask")
    mask = None if leaf is None else np.asarray(leaf, dtype=bool)
    demand = normalize_demand(make_pattern(pattern).demand(g, mask))
    model = make_routing(routing)
    links: list = []
    routers: list = []
    with obs.span("faults.targeted", kind=kind, k=k, routing=routing):
        _targeted_rounds(g, k, kind, demand, mask, model, engine,
                         require_connected, links, routers, device)
    return FaultSet(links=tuple(links), routers=tuple(routers))


def _targeted_rounds(g, k, kind, demand, mask, model, engine,
                     require_connected, links, routers, device):
    """The greedy kill-the-busiest rounds of :func:`targeted_faults`,
    mutating ``links``/``routers`` in place (one round per counter
    tick)."""
    for _ in range(k):
        obs.counter("faults.targeted_rounds").add(1.0)
        fs = FaultSet(links=tuple(links), routers=tuple(routers))
        gd = fs.apply(g) if not fs.empty else g
        dem = fs.restrict_demand(g, demand)
        act = fs.restrict_active(g, mask)
        res = model.evaluate(gd, dem, act, engine, device)
        surv = fs.survivors(g)
        if kind == "links":
            score = np.zeros(gd.num_edges)
            np.maximum.at(score, gd.arc_edge_id, res.loads)
            order = np.argsort(score)[::-1]
            cands = [(int(surv[gd.edges[e, 0]]), int(surv[gd.edges[e, 1]]))
                     for e in order]
            grow = lambda c: FaultSet(links=tuple(links) + (c,),
                                      routers=tuple(routers))
        else:
            score = np.zeros(gd.n)
            np.add.at(score, gd.arc_src, res.loads)
            order = np.argsort(score)[::-1]
            cands = [int(surv[v]) for v in order]
            grow = lambda c: FaultSet(links=tuple(links),
                                      routers=tuple(routers) + (c,))
        for cand in cands:
            trial = grow(cand)
            if not require_connected or fault_report(g, trial).evaluable:
                if kind == "links":
                    links.append(cand)
                else:
                    routers.append(cand)
                break
        else:
            raise ValueError(
                f"every remaining {kind[:-1]} cut disconnects "
                f"{g.name or 'the graph'} after {len(links) + len(routers)} "
                f"removals")


# ---------------------------------------------------------------------------
# Analytic reroute
# ---------------------------------------------------------------------------


def degraded_report(g: Graph, pattern, faults: FaultSet,
                    routing: str = "minimal", engine: str | None = None,
                    targets_mask=None, device=None):
    """``saturation_report`` of a faulted fabric.

    The pattern's demand is built and normalized on the PRISTINE graph
    (busiest pristine source = 1 unit), then restricted to the
    survivors: degraded theta is in the same units as pristine theta, so
    the ratio is the surviving throughput fraction.  Routing re-converges
    on the degraded graph — any registered model, on ``device``."""
    from .traffic import SaturationReport, make_pattern, normalize_demand
    device = resolve_device(device)
    pat = make_pattern(pattern)
    if targets_mask is None:
        targets_mask = g.meta.get("leaf_mask")
    demand = normalize_demand(pat.demand(g, targets_mask))
    if faults.empty:
        gd, dem, act = g, demand, None
        act = (np.arange(g.n) if targets_mask is None else
               np.nonzero(np.asarray(targets_mask, dtype=bool))[0])
    else:
        gd = faults.apply(g)
        dem = faults.restrict_demand(g, demand)
        act = faults.restrict_active(g, targets_mask)
    if len(act) < 2:
        raise ValueError("fewer than 2 active vertices survive the faults")
    if dem.sum() <= 0:
        raise ValueError("faults removed every demand source/target")
    model = make_routing(routing)
    res = model.evaluate(gd, dem, act, engine, device)
    mx = float(res.loads.max())
    mean = float(res.loads.mean())
    return SaturationReport(
        pattern=pat.name, routing=model.name, theta=1.0 / mx, u=mean / mx,
        max_load=mx, mean_load=mean, kbar_eff=res.kbar_eff,
        diameter=int(res.diameter), total_demand=float(dem.sum()),
        loads=res.loads, alpha=res.alpha, faults=faults.label)


@dataclass
class DegradationSweep:
    """theta-vs-failures curves of one (graph, pattern, routing).

    ``thetas[t, j]`` is trial t's theta at ``k_failures[j]`` dead
    components; within a trial the fault sets are NESTED (prefixes of
    one seeded failure order), so each trial's curve is monotone
    whenever theta is monotone under adding faults.  ``worst``/``mean``/
    ``best`` and the percentile ``bands`` summarize across trials."""

    pattern: str
    routing: str
    kind: str
    k_failures: tuple
    thetas: np.ndarray = field(repr=False)   # (trials, K)
    mean: np.ndarray = field(repr=False)
    worst: np.ndarray = field(repr=False)
    best: np.ndarray = field(repr=False)
    bands: dict = field(repr=False)          # percentile -> (K,) curve
    pristine_theta: float = 0.0
    trials: int = 0
    seed: int = 0


def _nested_draw(g: Graph, ks, kind: str, rng, max_tries: int):
    """One failure ORDER whose every k-prefix keeps the degraded graph
    evaluable; returns the permutation (edge or vertex ids)."""
    pool = g.num_edges if kind == "links" else g.n
    if ks[-1] > (pool if kind == "links" else g.n - 2):
        raise ValueError(f"k={ks[-1]} {kind} failures exceed the graph")
    for _ in range(max_tries):
        perm = rng.permutation(pool)
        ok = True
        for k in ks:
            if k == 0:
                continue
            if kind == "links":
                fs = FaultSet(links=_links_from_edges(g, perm[:k]))
            else:
                fs = FaultSet(routers=tuple(int(v) for v in perm[:k]))
            if not fault_report(g, fs).evaluable:
                ok = False
                break
        if ok:
            return perm
    raise ValueError(f"no connected nested {kind} failure order found in "
                     f"{max_tries} draws (max k={ks[-1]})")


def degradation_sweep(g: Graph, k_failures=(0, 1, 2, 5), trials: int = 8,
                      pattern="uniform", routing: str = "minimal",
                      kind: str = "links", seed: int = 0,
                      engine: str | None = None, targets_mask=None,
                      percentiles=(10, 50, 90),
                      max_tries: int = 64, device=None) -> DegradationSweep:
    """theta-vs-k curves with percentile bands: ``trials`` seeded nested
    failure orders, each evaluated at every k in ``k_failures`` under one
    routing model, on ``device``.  The resilience analogue of the
    paper's Table 5."""
    if kind not in ("links", "routers"):
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"options: links, routers")
    ks = tuple(sorted({int(k) for k in k_failures}))
    if ks[0] < 0:
        raise ValueError("k_failures must be >= 0")
    if targets_mask is None:
        targets_mask = g.meta.get("leaf_mask")
    device = resolve_device(device)
    from .traffic import saturation_report
    with obs.span("faults.degradation_sweep", kind=kind,
                  routing=routing, trials=int(trials), k_max=ks[-1]):
        pristine = saturation_report(g, pattern, routing=routing,
                                     engine=engine,
                                     targets_mask=targets_mask,
                                     device=device).theta
        thetas = np.empty((int(trials), len(ks)), dtype=np.float64)
        prog = obs.Progress("faults.trials", total=int(trials) * len(ks))
        for t in range(int(trials)):
            rng = np.random.default_rng(
                np.random.SeedSequence([int(seed), t]))
            perm = _nested_draw(g, ks, kind, rng, max_tries)
            for j, k in enumerate(ks):
                if k == 0:
                    thetas[t, j] = pristine
                    prog.step(trial=t, k=int(k))
                    continue
                if kind == "links":
                    fs = FaultSet(links=_links_from_edges(g, perm[:k]))
                else:
                    fs = FaultSet(routers=tuple(int(v) for v in perm[:k]))
                thetas[t, j] = degraded_report(
                    g, pattern, fs, routing=routing, engine=engine,
                    targets_mask=targets_mask, device=device).theta
                prog.step(trial=t, k=int(k), theta=float(thetas[t, j]))
    bands = {int(p): np.percentile(thetas, p, axis=0) for p in percentiles}
    return DegradationSweep(
        pattern=str(pattern), routing=str(routing), kind=kind, k_failures=ks,
        thetas=thetas, mean=thetas.mean(axis=0), worst=thetas.min(axis=0),
        best=thetas.max(axis=0), bands=bands, pristine_theta=float(pristine),
        trials=int(trials), seed=int(seed))
