"""Fabric models: a physical interconnect = topology graph + link rate +
terminals per router.  The paper's saturation analysis (Eq. 1: per-node
injection bandwidth a = Δ·u/k̄ link-equivalents) prices uniform-traffic
collectives on any fabric; a 3D torus builder covers the TPU-pod reference
point.

The port's counterpart of ``repro.fabric.model``.  A :class:`FabricModel`
routes on one device, the card unless it is made with ``device="cpu"``:
its k̄ and u (when not given), its pattern reports, placements and
simulations all run there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._device import resolve_device
from ..core.graph import Graph
from ..core.reference import dragonfly_canonical_stats
from ..core.utilization import utilization

__all__ = ["FabricModel", "torus3d_graph", "make_fabric"]


def torus3d_graph(x: int, y: int, z: int) -> Graph:
    """3D torus.  Dimensions of size 1 add no links; a dimension of size
    2 adds one link per pair, not a doubled wrap."""
    n = x * y * z
    coords = np.stack(np.unravel_index(np.arange(n), (x, y, z)), 1)
    edges = []
    for d, size in enumerate((x, y, z)):
        if size == 1:
            continue
        nxt = coords.copy()
        nxt[:, d] = (nxt[:, d] + 1) % size
        dst = np.ravel_multi_index((nxt[:, 0], nxt[:, 1], nxt[:, 2]),
                                   (x, y, z))
        mask = np.ones(n, dtype=bool)
        if size == 2:  # one edge, not a doubled wrap
            mask = coords[:, d] == 0
        edges.append(np.stack([np.arange(n)[mask], dst[mask]], 1))
    g = Graph(n, np.concatenate(edges), name=f"torus3d({x},{y},{z})")
    g.meta.update(family="torus3d", dims=(x, y, z))
    return g


@dataclass
class FabricModel:
    """``device`` is where the fabric routes: the card unless given
    (raises where there is none)."""

    graph: Graph
    link_gbps: float = 400.0          # per-link, each direction (50 GB/s)
    terminals_per_router: float = 1.0
    kbar: float | None = None
    u: float | None = None
    name: str = ""
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.kbar is None or self.u is None:
            if self.graph.meta.get("family") == "dragonfly":
                # canonical (l-g-l) routing, per the paper's Table 2 convention
                self.kbar, self.u = dragonfly_canonical_stats(self.graph.meta["h"])
            else:
                sources = None
                if self.graph.n > 3000:  # sample sources for very large graphs
                    rng = np.random.default_rng(0)
                    sources = rng.choice(self.graph.n, 256, replace=False)
                rep = utilization(self.graph, sources=sources,
                                  device=self.device)
                self.kbar, self.u = rep.kbar, rep.u
        if not self.name:
            self.name = self.graph.name

    @property
    def link_bytes_per_s(self) -> float:
        return self.link_gbps * 1e9 / 8

    @property
    def injection_links(self) -> float:
        """Eq. (1): per-ROUTER saturation injection bandwidth under uniform
        traffic, in link-equivalents: a = Δ·u/k̄."""
        return self.graph.max_degree * self.u / self.kbar

    @property
    def node_uniform_bw(self) -> float:
        """bytes/s each TERMINAL can inject at saturation (uniform traffic)."""
        return self.injection_links * self.link_bytes_per_s / self.terminals_per_router

    # Beyond this size the dense (N, N) demand matrices of the pattern
    # engine stop being the right tool (25k routers = 5 GB per matrix);
    # evaluate patterns on a representative smaller instance instead.
    PATTERN_MAX_N = 8192

    def pattern_report(self, pattern, routing: str = "minimal"):
        """Saturation analysis of one traffic pattern on this fabric
        (repro_torch.core.traffic), cached per (spec, routing) for
        registry-spec strings (ad-hoc TrafficPattern objects are cached
        by identity).

        ``routing`` is any registered routing model
        (repro_torch.core.routing): "minimal", "valiant", "ugal",
        "ugal(source)", ...  Non-uniform patterns always use the model's
        own path accounting, including on dragonfly — the canonical l-g-l
        convention this model applies to dragonfly's UNIFORM stats has
        no published per-pattern counterpart."""
        from ..core.traffic import make_pattern, saturation_report
        if self.graph.n > self.PATTERN_MAX_N:
            raise ValueError(
                f"pattern saturation needs dense (N, N) demand matrices; "
                f"N={self.graph.n} > {self.PATTERN_MAX_N}.  Evaluate the "
                f"pattern on a smaller instance of the same family.")
        pat = make_pattern(pattern)
        # spec strings key by value; ad-hoc TrafficPattern objects by
        # identity (the cached entry keeps the object alive, so its id is
        # stable) — repeated collective_time calls with the same object
        # then pay one saturation analysis, and a different object that
        # happens to reuse a registry name cannot alias a stale entry
        key = ((pattern, routing) if isinstance(pattern, str)
               else (id(pat), routing))
        cache = self.graph._struct_cache.setdefault("fabric_patterns", {})
        if key not in cache:
            cache[key] = (pat, saturation_report(self.graph, pat,
                                                 routing=routing,
                                                 device=self.device))
        return cache[key][1]

    def _is_uniform(self, pattern) -> bool:
        from ..core.traffic import make_pattern
        return make_pattern(pattern).name == "uniform"

    @staticmethod
    def _uniform_routing_kind(routing) -> str:
        """Classify a routing spec for the uniform fast path: "minimal"
        (also any UGAL blend — on uniform traffic the Valiant loads are
        exactly 2x the minimal loads, so the theta-maximizing blend is
        alpha = 1, pure minimal), "valiant", or "other" (unknown models
        evaluate through pattern_report)."""
        from ..core.routing import make_routing
        name = make_routing(routing).name  # validates the spec
        if name == "valiant":
            return "valiant"
        if name in ("minimal", "ugal", "ugal(source)") \
                or name.startswith("ugal_threshold"):
            # every threshold variant shares the blend's uniform identity
            # (alpha = 1 for finite T, minimal outright for T = inf)
            return "minimal"
        return "other"

    def pattern_node_bw(self, pattern, routing: str = "minimal") -> float:
        """bytes/s each TERMINAL can inject at saturation under an arbitrary
        traffic pattern — the generalized Eq. (1): theta replaces Δ·u/k̄.

        The uniform pattern routes through ``node_uniform_bw`` so fabric
        conventions are preserved exactly: dragonfly keeps its canonical
        l-g-l Table-2 stats (shortest-path theta is ~35% lower there) and
        Eq. 1's Δ (not mean-degree) convention holds on irregular graphs;
        Valiant halves it, and UGAL reduces to minimal (blend alpha = 1 on
        uniform traffic), per the uniform two-phase identity."""
        if self._is_uniform(pattern):
            kind = self._uniform_routing_kind(routing)
            if kind != "other":
                bw = self.node_uniform_bw
                return bw / 2.0 if kind == "valiant" else bw
        rep = self.pattern_report(pattern, routing)
        return rep.theta * self.link_bytes_per_s / self.terminals_per_router

    def place(self, mesh_shape, axis_names, strategy="group", seed: int = 0,
              schedule=None, routing="minimal"):
        """Place a (pod, data, model)-shaped chip mesh on this fabric via
        a registered placement strategy (fabric.placement)."""
        from .placement import place_mesh
        return place_mesh(self.graph, mesh_shape, axis_names,
                          int(self.terminals_per_router), strategy,
                          seed=seed, schedule=schedule, routing=routing,
                          device=self.device)

    def placement_report(self, profile, placement, routing: str = "ugal",
                         engine: str | None = None):
        """Saturation analysis of one (StepProfile, Placement) pair under
        a routing model: theta of the placement's router-level demand
        matrix in Eq. 1's link-equivalent units (fabric.placement)."""
        from .placement import placement_report
        if self.graph.n > self.PATTERN_MAX_N:
            raise ValueError(
                f"placement saturation needs dense (N, N) demand matrices; "
                f"N={self.graph.n} > {self.PATTERN_MAX_N}.")
        return placement_report(placement, profile, routing=routing,
                                engine=engine, device=self.device)

    def simulate_pattern(self, pattern, routing: str = "ugal_threshold(0)",
                         offered: float | None = None,
                         steps: int | None = None, config=None):
        """Replay a traffic pattern through the flow-level simulator
        (repro_torch.sim) on this fabric: the measured counterpart of
        ``pattern_report`` — per-hop threshold-UGAL, finite buffers, and
        queueing latency instead of the fluid closed form.  ``offered``
        defaults to 0.9x the matching fluid theta (a stable sub-saturation
        point whose Little's-law latency is meaningful); returns the
        SimRun (theta in link-equivalents, as everywhere)."""
        from ..sim import fluid_routing_spec, simulate
        if self.graph.n > self.PATTERN_MAX_N:
            raise ValueError(
                f"simulation needs dense (router, slot, dest) tensors; "
                f"N={self.graph.n} > {self.PATTERN_MAX_N}.")
        if offered is None:
            offered = 0.9 * self.pattern_report(
                pattern, fluid_routing_spec(routing)).theta
        return simulate(self.graph, pattern, routing=routing,
                        offered=offered, steps=steps, config=config,
                        device=self.device)

    def pattern_kbar(self, pattern, routing: str = "minimal") -> float:
        """Demand-weighted mean hop count under the pattern (2 phases under
        Valiant); prices the latency term of small-message collectives.
        Uniform keeps the fabric's own k̄ convention (see pattern_node_bw)."""
        if self._is_uniform(pattern):
            kind = self._uniform_routing_kind(routing)
            if kind != "other":
                return 2.0 * self.kbar if kind == "valiant" else self.kbar
        return self.pattern_report(pattern, routing).kbar_eff


def make_fabric(kind: str, link_gbps: float = 400.0, device=None,
                **kw) -> FabricModel:
    from ..core import (demi_pn_graph, dragonfly_graph, hamming_graph,
                        mms_graph, oft_graph, pn_graph)
    builders = {
        "demi_pn": demi_pn_graph, "pn": pn_graph, "oft": oft_graph,
        "mms": mms_graph, "slimfly": mms_graph, "dragonfly": dragonfly_graph,
        "hamming": hamming_graph, "torus3d": torus3d_graph,
    }
    delta0 = kw.pop("terminals_per_router", 1.0)
    g = builders[kind](*kw.pop("args", ()), **kw)
    return FabricModel(g, link_gbps=link_gbps, terminals_per_router=delta0,
                       name=g.name, device=device)
