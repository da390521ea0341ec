"""Routing models: pluggable maps from (graph, demand) to arc loads.

The port's counterpart of ``repro.core.routing``, numpy on the host
around the arc-load engines of :mod:`repro_torch.core.utilization`, which
run on the device the caller names.  Every model shares one interface:

    model = make_routing("ugal")
    res = model.evaluate(g, demand, active, engine, device)
    theta = 1.0 / res.loads.max()                # if demand is normalized

A model maps ``(graph, demand)`` to a per-arc load vector plus the
demand-weighted hop count and worst-case hop count of the routes it uses.
``saturation_report`` (repro_torch.core.traffic) is the user-facing entry
point: it normalizes demand so the busiest source injects one unit and
wraps the result with theta = 1/max_load.

Shipped models
--------------
``minimal``
    One weighted sweep: demand split evenly over all shortest paths.

``valiant``
    Exact expected two-phase load: phase 1 spreads each source's row sum
    over uniform random intermediates, phase 2 collects each target's
    column sum: two rank-1 demand matrices, so two weighted sweeps (one
    when both phases coincide, as under uniform traffic).

``ugal`` / ``ugal(source)``
    UGAL as the theta-maximizing convex blend ``L(alpha) = alpha * L_min
    + (1 - alpha) * L_val`` of the two pure load vectors.  The envelope
    ``max_a L_a(alpha)`` is piecewise linear and convex, so
    :func:`blend_optimum` finds its minimum exactly by a cutting-plane
    descent over envelope breakpoints.  ``ugal(source)`` refines the
    single alpha to one weight per source, solved as a small LP with
    scipy's linprog (one sweep per source, guarded to small graphs).

``ugal_threshold(T)``
    The fluid limit of per-hop threshold-UGAL: the ugal blend for any
    finite T, minimal for T = inf.

Under an obs session the shared sweeps are ``routing.sweep[minimal]`` /
``routing.sweep[valiant]`` spans inside ``routing.evaluate_models``, and
every blend solve counts ``routing.blend.solves`` and its breakpoint
probes ``routing.blend.probes``, as in the reference.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .. import obs
from .graph import Graph
from .utilization import arc_loads_weighted

__all__ = [
    "RoutingModel", "RoutingResult", "ROUTINGS", "register_routing",
    "make_routing", "blend_optimum", "evaluate_models", "valiant_demands",
    "parse_spec", "UGAL_SOURCE_MAX_N",
]


@dataclass
class RoutingResult:
    """Arc loads of one routing model on one (graph, demand) instance.

    ``loads`` is per directed arc in the graph's arc order; ``kbar_eff``
    the demand-weighted mean hops actually traveled (both phases under
    Valiant); ``diameter`` the longest hop count any demand travels (an
    upper bound for two-leg routes).  ``alpha`` is the blend weight on the
    minimal load vector for blend models (1.0 = pure minimal), ``alphas``
    the per-source weights when ``ugal(source)`` solved the LP, and
    ``breakpoints`` how many envelope lines the exact blend scan visited.
    """

    routing: str
    loads: np.ndarray = field(repr=False)
    kbar_eff: float = 0.0
    diameter: int = 0
    alpha: float | None = None
    alphas: np.ndarray | None = field(default=None, repr=False)
    breakpoints: int = 0

    @property
    def max_load(self) -> float:
        return float(self.loads.max())


@dataclass(frozen=True)
class RoutingModel:
    """A named routing model: ``evaluate(g, demand, active, engine,
    device)`` returns a :class:`RoutingResult`.  ``demand`` is a dense (N, N)
    matrix (diagonal ignored), ``active`` the sorted vertex ids that send
    and receive traffic (all vertices, or the leaf set of an indirect
    network), ``engine`` the arc-load engine and ``device`` where it runs
    (see repro_torch.core.utilization)."""

    name: str
    evaluate: Callable[..., RoutingResult] = field(repr=False)
    description: str = ""


ROUTINGS: dict[str, Callable[..., RoutingModel]] = {}


def register_routing(name: str):
    """Register a routing-model factory: ``fn(*args) -> RoutingModel``."""

    def deco(fn):
        ROUTINGS[name] = fn
        return fn

    return deco


_SPEC_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_-]*)\s*(?:\((.*)\))?\s*$")


def parse_spec(spec, registry: dict, kind: str):
    """Shared ``name`` / ``name(arg, ...)`` spec parser for the pattern
    and routing registries: tokens coerce int -> float -> str, and an
    unknown name raises ``ValueError("unknown {kind} ...")``."""
    m = _SPEC_RE.match(str(spec))
    if not m or m.group(1) not in registry:
        raise ValueError(f"unknown {kind} {spec!r}; "
                         f"options: {sorted(registry)}")
    name, argstr = m.group(1), m.group(2)
    args = []
    for tok in filter(None, (t.strip() for t in (argstr or "").split(","))):
        try:
            args.append(int(tok))
        except ValueError:
            try:
                args.append(float(tok))
            except ValueError:
                args.append(tok)
    return registry[name](*args)


def make_routing(spec) -> RoutingModel:
    """Build a routing model from a registry name with optional arguments:
    ``"minimal"``, ``"valiant"``, ``"ugal"``, ``"ugal(source)"``.  Passes
    RoutingModel instances through."""
    if isinstance(spec, RoutingModel):
        return spec
    return parse_spec(spec, ROUTINGS, "routing model")


# ---------------------------------------------------------------------------
# The two pure models
# ---------------------------------------------------------------------------


def valiant_demands(demand: np.ndarray, active: np.ndarray):
    """Exact expected two-phase Valiant demand: every packet routes
    s -> (uniform random intermediate m != endpoint, within the active
    set) -> t.  Phase 1 spreads each source's row sum over the
    intermediates, phase 2 collects each target's column sum from them —
    two rank-1 matrices, so Valiant costs two weighted sweeps whatever the
    pattern.  For uniform traffic this reproduces valiant_report exactly:
    2x the minimal loads at 2x k̄."""
    n = demand.shape[0]
    m = len(active)
    act = np.zeros(n, dtype=np.float64)
    act[active] = 1.0
    rs = demand.sum(axis=1)
    cs = demand.sum(axis=0)
    d1 = np.outer(rs, act) / (m - 1)
    d2 = np.outer(act, cs) / (m - 1)
    return d1, d2


def _minimal_parts(g: Graph, demand: np.ndarray, engine, device):
    with obs.span("routing.sweep[minimal]", n=g.n):
        return arc_loads_weighted(g, demand, engine=engine, device=device)


def _valiant_parts(g: Graph, demand: np.ndarray, active: np.ndarray, engine,
                   device):
    with obs.span("routing.sweep[valiant]", n=g.n):
        d1, d2 = valiant_demands(demand, active)
        l1, k1, dm1 = arc_loads_weighted(g, d1, engine=engine,
                                         device=device)
        if np.array_equal(d1, d2):  # e.g. uniform: both phases identical
            l2, k2, dm2 = l1, k1, dm1
        else:
            l2, k2, dm2 = arc_loads_weighted(g, d2, engine=engine,
                                             device=device)
    # upper bound on the longest two-leg route: the worst phase-1 and
    # phase-2 legs need not share an intermediate (tight on the
    # vertex-transitive families)
    return l1 + l2, k1 + k2, dm1 + dm2


@register_routing("minimal")
def _minimal() -> RoutingModel:
    def evaluate(g, demand, active, engine=None, device=None):
        loads, kbar, diam = _minimal_parts(g, demand, engine, device)
        return RoutingResult("minimal", loads, kbar, int(diam))

    return RoutingModel("minimal", evaluate,
                        "demand split evenly over all shortest paths")


@register_routing("valiant")
def _valiant() -> RoutingModel:
    def evaluate(g, demand, active, engine=None, device=None):
        loads, kbar, diam = _valiant_parts(g, demand, active, engine, device)
        return RoutingResult("valiant", loads, kbar, int(diam))

    return RoutingModel("valiant", evaluate,
                        "exact expected two-phase randomized routing")


# ---------------------------------------------------------------------------
# UGAL: the theta-maximizing convex blend
# ---------------------------------------------------------------------------


def blend_optimum(l_min: np.ndarray, l_val: np.ndarray,
                  max_iter: int = 10_000) -> tuple[float, float, int]:
    """Minimize ``f(alpha) = max(alpha*l_min + (1-alpha)*l_val)`` over
    ``alpha`` in [0, 1]; returns ``(alpha, f(alpha), breakpoints)``.

    Each arc contributes the line ``l_val[a] + alpha*(l_min[a]-l_val[a])``;
    f is their upper envelope — piecewise linear and convex — so the
    minimum sits at an endpoint or at a crossing of two envelope lines.
    Cutting-plane descent: keep one binding line at each end of the
    current bracket, jump to their crossing (the lower bound's argmin),
    evaluate the true envelope there (one O(arcs) max), and shrink the
    bracket with the newly discovered binding line.  Every iteration
    either certifies optimality (envelope meets the lower bound) or adds
    a distinct envelope line, so termination is finite and exact."""
    l_min = np.asarray(l_min, dtype=np.float64)
    l_val = np.asarray(l_val, dtype=np.float64)
    slope = l_min - l_val

    def probe(x: float):
        v = l_val + slope * x
        a = int(np.argmax(v))
        return float(v[a]), float(slope[a]), float(l_val[a])

    f0, s0, b0 = probe(0.0)
    f1, s1, b1 = probe(1.0)
    # a nonnegative binding slope at 0 (resp. nonpositive at 1) certifies
    # the endpoint: the convex envelope can only rise from there
    if s0 >= 0.0:
        return 0.0, f0, 1
    if s1 <= 0.0:
        return 1.0, f1, 1
    visited = 2
    slo, blo = s0, b0
    shi, bhi = s1, b1
    best_x, best_f = (0.0, f0) if f0 <= f1 else (1.0, f1)
    tol = 1e-12 * max(f0, f1)
    for _ in range(max_iter):
        x = (bhi - blo) / (slo - shi)  # crossing of the two binding lines
        lower = blo + slo * x          # lower bound on min f
        fx, sx, bx = probe(x)
        visited += 1
        if fx < best_f:
            best_x, best_f = x, fx
        if fx <= lower + tol:          # envelope meets its lower bound
            return best_x, best_f, visited
        if sx < 0.0:
            slo, blo = sx, bx
        elif sx > 0.0:
            shi, bhi = sx, bx
        else:                          # flat binding line: x is the optimum
            return x, fx, visited
    return best_x, best_f, visited


def _blend_result(min_parts, val_parts) -> RoutingResult:
    l_min, k_min, d_min = min_parts
    l_val, k_val, d_val = val_parts
    alpha, _, visited = blend_optimum(l_min, l_val)
    # breakpoint-probe telemetry: each visited point is one O(arcs)
    # envelope max, the blend solver's entire marginal cost
    obs.counter("routing.blend.solves").add(1.0)
    obs.counter("routing.blend.probes").add(float(visited))
    if alpha == 1.0:
        # pure minimal: reuse the exact sweep output bitwise (the balanced
        # case, e.g. any uniform demand where l_val == 2*l_min)
        return RoutingResult("ugal", l_min, k_min, int(d_min),
                             alpha=1.0, breakpoints=visited)
    if alpha == 0.0:
        return RoutingResult("ugal", l_val, k_val, int(d_val),
                             alpha=0.0, breakpoints=visited)
    loads = alpha * l_min + (1.0 - alpha) * l_val
    kbar = alpha * k_min + (1.0 - alpha) * k_val
    return RoutingResult("ugal", loads, kbar, int(max(d_min, d_val)),
                         alpha=float(alpha), breakpoints=visited)


def _ugal_blend(g, demand, active, engine, device):
    return _blend_result(_minimal_parts(g, demand, engine, device),
                         _valiant_parts(g, demand, active, engine, device))


# Per-source granularity needs one sweep per source (the batched engines
# only return summed loads); guard the LP path to instances where that
# and the (sources x arcs) constraint matrix stay small.
UGAL_SOURCE_MAX_N = 512


def _per_source_vectors(g, demand, active, engine, device):
    """(S, A) minimal and Valiant load matrices plus per-source
    (dist_sum, demand_total) pairs, one row per demand-carrying source."""
    sources = np.nonzero(demand.any(axis=1))[0]
    n_arcs = len(g.arc_src)
    lm = np.zeros((len(sources), n_arcs))
    lv = np.zeros((len(sources), n_arcs))
    km = np.zeros(len(sources))
    kv = np.zeros(len(sources))
    tot = np.zeros(len(sources))
    dm = dv = 0
    for i, s in enumerate(sources):
        row = np.zeros_like(demand)
        row[s] = demand[s]
        tot[i] = row.sum()
        lm[i], kbar_s, d1 = arc_loads_weighted(g, row, engine=engine,
                                               device=device)
        km[i] = kbar_s * tot[i]
        lv[i], kv_s, d2 = _valiant_parts(g, row, active, engine, device)
        kv[i] = kv_s * tot[i]
        dm, dv = max(dm, int(d1)), max(dv, int(d2))
    return sources, lm, lv, km, kv, tot, dm, dv


def _ugal_source_lp(g, demand, active, engine, device):
    """Per-source blend weights via LP: minimize t s.t. for every arc
    ``sum_s alpha_s*l_min[s] + (1-alpha_s)*l_val[s] <= t``, alpha in
    [0, 1]^S.  Exact theta at the granularity a per-packet adaptive
    router actually has; needs scipy and one sweep per source."""
    try:
        from scipy.optimize import linprog
    except ImportError as e:  # pragma: no cover - scipy is in the image
        raise RuntimeError(
            "ugal(source) solves a per-source LP and needs scipy; "
            "use the closed-form global blend 'ugal' instead") from e
    if g.n > UGAL_SOURCE_MAX_N:
        raise ValueError(
            f"ugal(source) runs one sweep per source and an (S x A) LP; "
            f"N={g.n} > {UGAL_SOURCE_MAX_N}.  Use 'ugal' (global blend) "
            f"or a smaller instance of the same family.")
    srcs, lm, lv, km, kv, tot, d_min, d_val = _per_source_vectors(
        g, demand, active, engine, device)
    s_count, n_arcs = lm.shape
    # variables x = (alpha_0..alpha_{S-1}, t)
    a_ub = np.hstack([(lm - lv).T, -np.ones((n_arcs, 1))])
    b_ub = -lv.sum(axis=0)
    c = np.zeros(s_count + 1)
    c[-1] = 1.0
    bounds = [(0.0, 1.0)] * s_count + [(None, None)]
    res = linprog(c, A_ub=a_ub, b_ub=b_ub, bounds=bounds, method="highs")
    if not res.success:  # pragma: no cover - LP is always feasible/bounded
        raise RuntimeError(f"ugal(source) LP failed: {res.message}")
    alphas = np.clip(res.x[:s_count], 0.0, 1.0)
    loads = alphas @ lm + (1.0 - alphas) @ lv
    total = tot.sum()
    kbar = float((alphas * km + (1.0 - alphas) * kv).sum() / total)
    full = np.zeros(g.n)
    full[srcs] = alphas
    mean_alpha = float((alphas * tot).sum() / total)
    return RoutingResult("ugal(source)", loads, kbar,
                         int(max(d_min, d_val)), alpha=mean_alpha,
                         alphas=full)


@register_routing("ugal_threshold")
def _ugal_threshold(threshold: float = 0.0) -> RoutingModel:
    """Fluid approximation of per-hop threshold-UGAL: divert a packet to
    the Valiant detour only when the minimal queue's expected delay
    exceeds the detour estimate by more than ``threshold`` flits.

    In the fluid (infinite-buffer) limit the saturation throughput is
    THRESHOLD-INVARIANT for any finite T: below the blend optimum the
    margin keeps queues bounded and traffic minimal; at saturation the
    minimal queues grow until the rule fires, so the steady-state split
    converges to the same theta-maximizing blend — T only shifts the
    queue depth (and therefore latency) at which diversion starts, which
    the simulator (repro_torch.sim) resolves and this closed form cannot.
    ``ugal_threshold(inf)`` never diverts and degenerates to minimal —
    the same degeneration a finite buffer shallower than T forces, since
    a queue can then never grow past the margin (see docs/simulation.md).
    The registry thus exposes the fluid approximation next to the simulator's
    measured ground truth under one spec family."""
    t = float(threshold)
    if not t >= 0.0:  # rejects negatives, -inf, and nan; +inf passes
        raise ValueError(f"threshold must be >= 0 or inf, got {threshold!r}")
    name = f"ugal_threshold({t:g})"

    def evaluate(g, demand, active, engine=None, device=None):
        if np.isinf(t):
            loads, kbar, diam = _minimal_parts(g, demand, engine, device)
            return RoutingResult(name, loads, kbar, int(diam), alpha=1.0)
        res = _ugal_blend(g, demand, active, engine, device)
        res.routing = name
        return res

    return RoutingModel(name, evaluate,
                        "threshold-UGAL fluid limit (= the ugal blend; "
                        "inf = minimal)")


@register_routing("ugal")
def _ugal(granularity: str = "global") -> RoutingModel:
    if granularity not in ("global", "source"):
        raise ValueError(f"ugal granularity must be 'global' or 'source', "
                         f"got {granularity!r}")
    if granularity == "source":
        return RoutingModel(
            "ugal(source)",
            lambda g, demand, active, engine=None, device=None:
                _ugal_source_lp(g, demand, active, engine, device),
            "per-source theta-maximizing blend (LP)")
    return RoutingModel(
        "ugal",
        lambda g, demand, active, engine=None, device=None:
            _ugal_blend(g, demand, active, engine, device),
        "theta-maximizing convex blend of minimal and Valiant")


# ---------------------------------------------------------------------------
# Shared-sweep evaluation
# ---------------------------------------------------------------------------


def _shared_kind(spec) -> str | None:
    """'minimal' | 'valiant' | 'ugal' when a STRING spec resolves through
    the built-in factories to the sweep-sharing trio; None for custom
    factories, RoutingModel instances, and ugal(source) — those always
    run their own ``evaluate``, even if their display name collides with
    a built-in's."""
    if not isinstance(spec, str):
        return None
    m = _SPEC_RE.match(spec)
    factory = ROUTINGS.get(m.group(1)) if m else None
    if factory is _minimal:
        return "minimal"
    if factory is _valiant:
        return "valiant"
    if factory is _ugal and make_routing(spec).name == "ugal":
        return "ugal"  # the global blend; ugal(source) needs its own path
    return None


def evaluate_models(g: Graph, demand: np.ndarray, active: np.ndarray,
                    models=("minimal", "valiant", "ugal"),
                    engine: str | None = None, device=None) -> dict:
    """Evaluate several routing models on one demand matrix, sharing the
    minimal and Valiant sweeps across the built-in trio (ugal adds only
    its O(arcs * breakpoints) scan).  The result dict is keyed by each
    entry of ``models`` verbatim (spec string or RoutingModel instance).
    Sweep sharing applies only to specs resolving to the built-in
    factories (see :func:`_shared_kind`); everything else evaluates
    through its own ``evaluate``."""
    out: dict = {}
    min_parts = val_parts = None
    with obs.span("routing.evaluate_models", n=g.n, models=len(models)):
        for spec in models:
            kind = _shared_kind(spec)
            if kind in ("minimal", "ugal") and min_parts is None:
                min_parts = _minimal_parts(g, demand, engine, device)
            if kind in ("valiant", "ugal") and val_parts is None:
                val_parts = _valiant_parts(g, demand, active, engine,
                                           device)
            if kind == "minimal":
                loads, kbar, diam = min_parts
                out[spec] = RoutingResult("minimal", loads, kbar, int(diam))
            elif kind == "valiant":
                loads, kbar, diam = val_parts
                out[spec] = RoutingResult("valiant", loads, kbar, int(diam))
            elif kind == "ugal":
                out[spec] = _blend_result(min_parts, val_parts)
            else:
                out[spec] = make_routing(spec).evaluate(g, demand, active,
                                                        engine, device)
    return out
