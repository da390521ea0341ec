"""Traffic patterns and their analytic saturation throughput.

The port's own copy of the pattern registry of ``repro.core.traffic``,
numpy only, so that demands stay bit-equal to the reference's:
``random_permutation`` keeps ``np.random.default_rng(seed)``.  A pattern
builds a dense (N, N) float64 demand for any graph;
:func:`normalize_demand` scales it so the busiest source injects one
unit, the normalization behind every theta.

  uniform             all-to-all, 1 unit per ordered pair
  bit_reversal        rank i -> bit-reversed rank
  transpose           (r, c) -> (c, r) on the largest square rank grid
  shift(k)            rank i -> i+k mod m
  tornado             shift by ceil(k/2)-1 within coordinate 0's ring on
                      a torus, by ceil(m/2)-1 on the rank ring elsewhere
  random_permutation(seed)  a sampled permutation
  hot_region(frac, boost)   all-to-all with a boosted hot target region
  collective(op)      demand of one fabric collective

:func:`saturation_report` evaluates one pattern under one routing model
(repro_torch.core.routing) on the arc-load engines of
repro_torch.core.utilization, on the card unless ``device="cpu"``:
theta = 1/max arc load of the normalized demand.  :func:`saturation_sweep`
runs a battery of patterns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .._device import resolve_device
from .graph import Graph
from .routing import make_routing, parse_spec

__all__ = [
    "TrafficPattern", "PATTERNS", "register_pattern", "make_pattern",
    "matrix_pattern", "COLLECTIVE_OPS", "normalize_demand", "parse_spec",
    "SaturationReport", "saturation_report", "saturation_sweep",
    "DEFAULT_SWEEP",
]


@dataclass(frozen=True)
class TrafficPattern:
    """A named recipe producing a demand matrix for any graph.

    ``builder(g, active)`` receives the graph and the sorted vertex ids
    that send/receive traffic (all vertices, or the leaf set of an
    indirect network) and returns a dense (N, N) float64 demand matrix.
    """

    name: str
    builder: Callable[[Graph, np.ndarray], np.ndarray] = field(repr=False)
    description: str = ""

    def demand(self, g: Graph, targets_mask: np.ndarray | None = None) -> np.ndarray:
        if targets_mask is None:
            targets_mask = g.meta.get("leaf_mask")
        if targets_mask is None:
            active = np.arange(g.n)
        else:
            active = np.nonzero(np.asarray(targets_mask, dtype=bool))[0]
        if len(active) < 2:
            raise ValueError("need at least 2 active vertices")
        d = self.builder(g, active)
        np.fill_diagonal(d, 0.0)
        return d


PATTERNS: dict[str, Callable[..., TrafficPattern]] = {}


def register_pattern(name: str):
    """Register a pattern factory: ``fn(*args) -> TrafficPattern``."""

    def deco(fn):
        PATTERNS[name] = fn
        return fn

    return deco


def _perm_demand(n: int, active: np.ndarray, perm: np.ndarray,
                 weight: float = 1.0) -> np.ndarray:
    """Demand matrix for rank permutation ``perm`` over the active set.
    Fixed points become self-demand and are zeroed by ``demand()``."""
    d = np.zeros((n, n), dtype=np.float64)
    d[active, active[perm]] = weight
    return d


@register_pattern("uniform")
def _uniform() -> TrafficPattern:
    def build(g, active):
        d = np.zeros((g.n, g.n), dtype=np.float64)
        d[np.ix_(active, active)] = 1.0
        return d

    return TrafficPattern("uniform", build, "all-to-all, 1 unit per ordered pair")


@register_pattern("bit_reversal")
def _bit_reversal() -> TrafficPattern:
    def build(g, active):
        m = len(active)
        bits = max(1, (m - 1).bit_length())
        i = np.arange(m)
        rev = np.zeros(m, dtype=np.int64)
        for b in range(bits):
            rev |= ((i >> b) & 1) << (bits - 1 - b)
        perm = np.where(rev < m, rev, i)  # out-of-range reversals stay home
        return _perm_demand(g.n, active, perm)

    return TrafficPattern("bit_reversal", build,
                          "rank -> bit-reversed rank (FFT exchange phase)")


@register_pattern("transpose")
def _transpose() -> TrafficPattern:
    def build(g, active):
        m = len(active)
        side = math.isqrt(m)
        perm = np.arange(m)
        sq = side * side
        r, c = np.divmod(np.arange(sq), side)
        perm[:sq] = c * side + r  # (r, c) -> (c, r); ranks beyond sq stay home
        return _perm_demand(g.n, active, perm)

    return TrafficPattern("transpose", build,
                          "matrix transpose on the largest square rank grid")


@register_pattern("shift")
def _shift(k: int = 1) -> TrafficPattern:
    def build(g, active):
        m = len(active)
        perm = (np.arange(m) + int(k)) % m
        return _perm_demand(g.n, active, perm)

    return TrafficPattern(f"shift({k})", build, f"rank i -> i+{k} mod m")


@register_pattern("tornado")
def _tornado() -> TrafficPattern:
    # The classic Dally-Towles adversary: shift by ceil(k/2)-1 — one hop
    # SHORT of halfway — so every packet travels the same direction and
    # minimal routing loads only half the ring's arcs.  On a k-ary n-cube
    # the textbook form shifts coordinate 0 within its own ring (each node
    # (x, y, ...) sends to (x + ceil(k/2)-1 mod k, y, ...)); on anything
    # else the shift applies to the rank ring.  (A flat rank shift(m//2)
    # splits both directions: theta 1.0 on the 4^3 torus, no adversary.)
    def build(g, active):
        dims = g.meta.get("dims")
        if (g.meta.get("family") == "torus3d" and dims
                and len(active) == g.n):
            coords = list(np.unravel_index(np.arange(g.n), dims))
            d = next((i for i, s in enumerate(dims) if s >= 2), 0)
            k = dims[d]
            coords[d] = (coords[d] + max(1, (k + 1) // 2 - 1)) % k
            perm = np.ravel_multi_index(coords, dims)
            return _perm_demand(g.n, active, perm)
        m = len(active)
        k = max(1, (m + 1) // 2 - 1)
        perm = (np.arange(m) + k) % m
        return _perm_demand(g.n, active, perm)

    return TrafficPattern("tornado", build,
                          "one-directional near-half-ring shift "
                          "(the classic torus adversary)")


@register_pattern("random_permutation")
def _random_permutation(seed: int = 0) -> TrafficPattern:
    def build(g, active):
        rng = np.random.default_rng(int(seed))
        perm = rng.permutation(len(active))
        return _perm_demand(g.n, active, perm)

    return TrafficPattern(f"random_permutation({seed})", build,
                          "a sampled rank permutation")


@register_pattern("hot_region")
def _hot_region(frac: float = 0.125, boost: float = 8.0) -> TrafficPattern:
    if not 0.0 < frac < 1.0:
        raise ValueError(f"frac must be in (0, 1), got {frac}")

    def build(g, active):
        m = len(active)
        hot = active[: max(1, int(round(frac * m)))]
        d = np.zeros((g.n, g.n), dtype=np.float64)
        d[np.ix_(active, active)] = 1.0
        d[np.ix_(active, hot)] = float(boost)
        return d

    return TrafficPattern(f"hot_region({frac},{boost})", build,
                          f"all-to-all with a {boost}x-hot {frac:.0%} target region")


COLLECTIVE_OPS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
                  "ring-all-gather", "ring-reduce-scatter", "ring-all-reduce")


@register_pattern("collective")
def _collective(op: str = "all-reduce", bytes_global: float = 1.0) -> TrafficPattern:
    """Demand matrix of one collective, matching fabric.collectives' byte
    accounting: spread ops send ``bytes/m`` to every peer (their uniform-
    destination schedule is the paper's uniform traffic); ring ops push the
    same total around the rank ring, i.e. ``(m-1)/m · bytes`` (2x for
    all-reduce) down each rank's shift(1) arc."""
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {op!r}; options: {COLLECTIVE_OPS}")

    def build(g, active):
        m = len(active)
        per_pair = float(bytes_global) / m
        if op.startswith("ring-"):
            phases = 2 * (m - 1) if op == "ring-all-reduce" else m - 1
            perm = (np.arange(m) + 1) % m
            return _perm_demand(g.n, active, perm, weight=phases * per_pair)
        scale = 2.0 if op == "all-reduce" else 1.0  # rs + ag
        d = np.zeros((g.n, g.n), dtype=np.float64)
        d[np.ix_(active, active)] = scale * per_pair
        return d

    return TrafficPattern(f"collective({op})", build,
                          f"one {op} of {bytes_global:g} bytes (global)")


def matrix_pattern(demand, name: str | None = None) -> TrafficPattern:
    """Wrap a raw (N, N) demand matrix as an ad-hoc TrafficPattern, so
    explicit matrices feed the simulator without registering a builder.
    The matrix is copied at build time (``demand()`` zeroes the
    diagonal)."""
    arr = np.asarray(demand, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"demand matrix must be square (N, N), "
                         f"got shape {arr.shape}")

    def build(g, active):
        if arr.shape != (g.n, g.n):
            raise ValueError(f"demand matrix is {arr.shape}, graph has "
                             f"N={g.n}")
        return arr.copy()

    label = name or f"matrix({arr.shape[0]}x{arr.shape[1]})"
    return TrafficPattern(label, build, "explicit demand matrix")


def make_pattern(spec) -> TrafficPattern:
    """Build a pattern from a registry name with optional arguments:
    ``"tornado"``, ``"shift(3)"``, ``"hot_region(0.2, 4)"``,
    ``"collective(ring-all-reduce)"``.  Passes TrafficPattern instances
    through and wraps raw (N, N) arrays via :func:`matrix_pattern`."""
    if isinstance(spec, TrafficPattern):
        return spec
    if isinstance(spec, (np.ndarray, list, tuple)) or (
            hasattr(spec, "__array__") and not isinstance(spec, str)):
        return matrix_pattern(spec)
    return parse_spec(spec, PATTERNS, "traffic pattern")


def normalize_demand(demand: np.ndarray) -> np.ndarray:
    """Scale a demand matrix so the busiest source injects one unit —
    the normalization behind every theta."""
    peak = demand.sum(axis=1).max()
    if peak <= 0:
        raise ValueError("demand matrix is all zero")
    return demand / peak


# ---------------------------------------------------------------------------
# Saturation analysis
# ---------------------------------------------------------------------------


@dataclass
class SaturationReport:
    """Load statistics of one (pattern, routing) on one graph.

    Demand is normalized so the busiest source injects 1 unit; arcs have
    unit capacity, so ``theta = 1/max_load`` is the per-node saturation
    injection rate in link-equivalents (uniform: Eq. 1's a = Δ·u/k̄) and
    ``u = mean/max`` is the paper's balance figure for this pattern."""

    pattern: str
    routing: str
    theta: float
    u: float
    max_load: float
    mean_load: float
    kbar_eff: float  # demand-weighted hops (both phases under Valiant)
    diameter: int    # longest hops traveled (Valiant: two-leg upper bound)
    total_demand: float
    loads: np.ndarray = field(repr=False)
    alpha: float | None = None  # blend weight on minimal (ugal models)
    faults: str | None = None   # FaultSet label when evaluated degraded


def saturation_report(g: Graph, pattern, routing: str = "minimal",
                      engine: str | None = None,
                      targets_mask: np.ndarray | None = None,
                      faults=None, device=None) -> SaturationReport:
    """Evaluate one traffic pattern on ``g`` under one routing model.

    ``pattern`` is a spec for :func:`make_pattern` (a registry name, a
    TrafficPattern, or a raw (N, N) demand matrix); ``routing`` a spec for
    :func:`repro_torch.core.routing.make_routing` ("minimal", "valiant",
    "ugal", "ugal(source)", "ugal_threshold(T)", or a RoutingModel);
    ``engine`` the arc-load engine (``auto``, ``dense``, ``fused``,
    ``orbit``); ``targets_mask`` defaults to the graph's leaf mask for
    indirect networks.  With ``faults`` (a :class:`repro_torch.core.faults.FaultSet`)
    the pattern is built and normalized on the pristine graph, restricted
    to the survivors and evaluated on the degraded graph: see
    :func:`repro_torch.core.faults.degraded_report`.  Runs on the card
    unless ``device="cpu"``."""
    device = resolve_device(device)
    if faults is not None and not faults.empty:
        from .faults import degraded_report
        return degraded_report(g, pattern, faults, routing=routing,
                               engine=engine, targets_mask=targets_mask,
                               device=device)
    model = make_routing(routing)
    pat = make_pattern(pattern)
    if targets_mask is None:
        targets_mask = g.meta.get("leaf_mask")
    demand = normalize_demand(pat.demand(g, targets_mask))
    total = float(demand.sum())
    active = (np.arange(g.n) if targets_mask is None
              else np.nonzero(np.asarray(targets_mask, dtype=bool))[0])
    res = model.evaluate(g, demand, active, engine, device)

    mx = float(res.loads.max())
    mean = float(res.loads.mean())
    return SaturationReport(
        pattern=pat.name, routing=model.name, theta=1.0 / mx, u=mean / mx,
        max_load=mx, mean_load=mean, kbar_eff=res.kbar_eff,
        diameter=int(res.diameter), total_demand=total, loads=res.loads,
        alpha=res.alpha)


DEFAULT_SWEEP = ("uniform", "bit_reversal", "transpose", "tornado",
                 "random_permutation", "hot_region")


def saturation_sweep(g: Graph, patterns=DEFAULT_SWEEP,
                     routings=("minimal", "valiant"),
                     engine: str | None = None,
                     targets_mask: np.ndarray | None = None, device=None):
    """Run a battery of patterns; returns ``(reports, summary)`` where
    ``summary`` names the worst pattern per routing: min theta (the
    throughput guarantee) and the worst-case u over patterns."""
    device = resolve_device(device)
    reports = [saturation_report(g, p, routing=r, engine=engine,
                                 targets_mask=targets_mask, device=device)
               for p in patterns for r in routings]
    summary = {}
    for r in routings:
        rs = [rep for rep in reports if rep.routing == r]
        worst = min(rs, key=lambda rep: rep.theta)
        summary[r] = {"min_theta": worst.theta, "worst_pattern": worst.pattern,
                      "worst_u": min(rep.u for rep in rs)}
    return reports, summary
