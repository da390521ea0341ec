"""Link utilization and per-arc loads: the analytic side of every theta.

The port's counterpart of ``repro.core.utilization``.  With one unit of
traffic per ordered vertex pair (or any demand matrix D[s, t]), split
evenly across all shortest paths, each directed arc carries some load;
saturation normalizes the maximum arc to 1, so

    u = mean(arc load) / max(arc load)

and the serviceable compute nodes per router are Delta0 = Delta·u/k̄.

Computed as a Brandes-style shortest-path DAG accumulation, a block of
sources at a time, one BFS level per step (the reference's level-
synchronous ``jax`` and ``pallas`` engines), on the device the caller
names.  Engines:

  dense  — counterpart of the reference's ``jax`` engine: the forward
           sigma recurrence and the backward delta recurrence as
           (S, N) x (N, N) ``torch.matmul`` products on the dense float64
           adjacency, each followed by its mask.
  fused  — counterpart of ``pallas``: the same recurrences through the
           mask+GEMM kernels of :mod:`repro_torch.kernels.mask_gemm`
           (sparse adjacency, mask epilogue in the kernel), float64 on the
           card; on CPU tensors the kernels' plain versions run.
  orbit  — the reference's automorphism shortcut (:mod:`.orbits`): one
           sweep from one representative per vertex orbit that the
           targets use, on the exact engine below, its loads summed per
           arc orbit and spread over the orbit; raises where the graph's
           family has no known generators (or is degraded).
  auto   — the orbit shortcut where it applies (default sources, a
           family with generators), else the exact engine: ``fused`` on
           a CUDA device, ``dense`` on the CPU.

``engine=None`` (every entry point's default) takes the ``util_engine``
perf flag (:mod:`repro_torch.perf`, ``auto`` unless ``REPRO_PERF`` sets
it), as in the reference; ``util_orbits=0`` keeps ``auto`` off the
orbit shortcut and off the weighted path's uniform-demand rerouting;
a non-zero ``util_block`` sets the rows of a source block.

The reference's numpy-only engines (``naive``, ``numpy``, ``csr``) are
not ported and raise ``ValueError``: the ``dense`` and ``fused`` engines
compute what they compute.  Every entry point runs on the card unless
``device="cpu"`` is passed.

Under an obs session each call is a ``util.arc_loads`` /
``util.arc_loads_weighted`` span, counted as ``util.dispatch[<engine
asked for>]``; where ``auto`` or ``orbit`` resolves, ``util.engine
[dense|fused]`` names the exact engine that ran the sweeps and
``util.engine[orbit]`` counts the shortcut taken.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from .._device import resolve_device
from ..perf import flags
from ..kernels.mask_gemm import backward_step, frontier_step
from ..kernels.ref import backward_epilogue, frontier_epilogue
from .graph import Graph, adjacency_csr, adjacency_dense
from .orbits import orbit_info

__all__ = ["arc_loads", "arc_loads_weighted", "utilization",
           "UtilizationReport", "valiant_report", "resolve_engine",
           "ENGINES"]

ENGINES = ("auto", "dense", "fused", "orbit")
# the reference's numpy-only engines, which the port does not carry over
_NOT_PORTED = ("naive", "numpy", "csr")
_PORT_NAME = {"jax": "dense", "pallas": "fused"}

# ~256 MB per (S, arc-chunk) float64 gather in the per-arc reduction
_ARC_CHUNK_BYTES = 256 << 20


@dataclass
class UtilizationReport:
    u: float
    mean_load: float
    max_load: float
    loads: np.ndarray  # per directed arc, 1 unit per ordered pair
    kbar: float  # average distance between (restricted) pairs
    diameter: int


def _engine_name(engine) -> str:
    """The engine's name, lower case (None: the ``util_engine`` perf
    flag); unknown and not-ported names raise."""
    eng = str(flags().util_engine if engine is None else engine).lower()
    if eng in _NOT_PORTED:
        raise ValueError(
            f"engine {eng!r} is one of the reference's numpy-only engines, "
            f"which the port does not carry over (ROADMAP.md, queue 1; "
            f"the dense and fused engines compute the same loads); "
            f"options: {ENGINES}")
    if eng in _PORT_NAME:
        raise ValueError(f"unknown engine {eng!r}; the port names the "
                         f"reference's {eng!r} engine "
                         f"{_PORT_NAME[eng]!r}; options: {ENGINES}")
    if eng not in ENGINES:
        raise ValueError(f"unknown engine {eng!r}; options: {ENGINES}")
    return eng


def resolve_engine(engine, device: torch.device) -> str:
    """The exact engine that runs the sweeps: ``auto`` and ``orbit`` run
    ``fused`` on a CUDA device and ``dense`` elsewhere (the orbit
    shortcut sits above this choice); unknown and not-ported names
    raise."""
    eng = _engine_name(engine)
    if eng in ("auto", "orbit"):
        return "fused" if device.type == "cuda" else "dense"
    return eng


def _source_block_rows(n: int) -> int:
    blk = flags().util_block
    if blk > 0:
        return blk
    # ~48 MB per (B, N) float64 working array
    return max(32, (48 << 20) // max(8 * n, 1))


def _arc_sum(sigma, ctot, dist, arc_u, arc_v) -> torch.Tensor:
    """Per-arc load of one source block: ``sum_s sigma[s, u] * ctot[s, v]``
    over the tree arcs ``dist[s, v] == dist[s, u] + 1``, in arc chunks
    that bound the (S, chunk) gathers."""
    b = sigma.shape[0]
    out = torch.empty(arc_u.shape[0], dtype=sigma.dtype, device=sigma.device)
    chunk = max(1, _ARC_CHUNK_BYTES // max(8 * b, 1))
    for lo in range(0, arc_u.shape[0], chunk):
        au, av = arc_u[lo: lo + chunk], arc_v[lo: lo + chunk]
        tree = dist[:, av] == dist[:, au] + 1
        out[lo: lo + chunk] = (sigma[:, au] * ctot[:, av] * tree).sum(dim=0)
    return out


def _level_ops(g: Graph, engine: str, device: torch.device):
    """``(forward, backward)``: one BFS level and one dependency level of
    a source block, for the dense engine or the fused kernels."""
    if engine == "fused":
        csr = adjacency_csr(g, torch.float64, device)

        def forward(front, dist, sigma, lvl):
            return frontier_step(front, csr, dist, sigma, lvl)

        def backward(coeff, dist, sigma, delta, lvl):
            return backward_step(coeff, csr, dist, sigma, delta, lvl)

        return forward, backward
    adj = adjacency_dense(g, torch.float64, device)

    def forward(front, dist, sigma, lvl):
        return frontier_epilogue(front @ adj, dist, sigma, lvl)

    def backward(coeff, dist, sigma, delta, lvl):
        return backward_epilogue(coeff @ adj, dist, sigma, delta, lvl)

    return forward, backward


def _loads(g: Graph, sources: np.ndarray, targets_mask: np.ndarray,
           demand: np.ndarray | None, engine: str, device: torch.device):
    """``(loads, dist_sum, pair_count, diameter)`` of the sources' traffic
    (uniform to every target, or the rows of ``demand``)."""
    n = g.n
    f64 = torch.float64
    forward, backward = _level_ops(g, engine, device)
    arc_u = torch.as_tensor(g.arc_src, device=device)
    arc_v = torch.as_tensor(g.indices, device=device)
    tm = torch.as_tensor(targets_mask, device=device)
    t_count = int(targets_mask.sum())
    loads = torch.zeros(len(g.arc_src), dtype=f64, device=device)
    dist_sum = 0.0
    pair_count: float = 0
    diam = 0
    block = _source_block_rows(n)
    for lo in range(0, len(sources), block):
        sb = sources[lo: lo + block]
        b = len(sb)
        rows = torch.arange(b, device=device)
        cols = torch.as_tensor(sb, device=device)
        front = torch.zeros((b, n), dtype=f64, device=device)
        front[rows, cols] = 1.0
        dist = torch.full((b, n), -1, dtype=torch.int32, device=device)
        dist[rows, cols] = 0
        sigma = front.clone()
        lvl = 0
        while True:
            lvl += 1
            front, dist, sigma, any_new = forward(front, dist, sigma, lvl)
            if not int(any_new):          # one host read per level
                maxd = lvl - 1
                break
        if bool((dist < 0).any()):
            raise ValueError("graph is disconnected")
        if demand is None:
            w = tm.to(f64)[None, :]
            dm = dist[:, tm]
            diam = max(diam, int(dm.max()))
            dist_sum += float(dm.sum(dtype=torch.int64))
            pair_count += b * t_count - int(targets_mask[sb].sum())
        else:
            w_np = demand[sb]
            w = torch.as_tensor(w_np, device=device)
            active = w > 0
            if w_np.any():
                diam = max(diam, int(dist[active].max()))
            dist_sum += float((dist * w).sum())
            pair_count += float(w_np.sum())

        delta = torch.zeros((b, n), dtype=f64, device=device)
        ctot = torch.zeros((b, n), dtype=f64, device=device)
        one = torch.ones((), dtype=f64, device=device)
        zero = torch.zeros((), dtype=f64, device=device)
        for lv in range(maxd, 0, -1):
            m = dist == lv
            coeff = torch.where(m, (w + delta) / torch.where(m, sigma, one),
                                zero)
            delta = backward(coeff, dist, sigma, delta, lv - 1)
            ctot += coeff
        loads += _arc_sum(sigma, ctot, dist, arc_u, arc_v)
    return loads.cpu().numpy(), dist_sum, pair_count, diam


def _loads_orbit(g: Graph, targets_mask: np.ndarray, engine: str,
                 device: torch.device):
    """One sweep per vertex orbit that the targets use, on the exact
    ``engine``; None when no known automorphism subgroup applies (the
    caller falls back to the exact engine)."""
    full = bool(targets_mask.all())
    info = orbit_info(g, None if full else targets_mask)
    if info is None:
        return None
    t_count = int(targets_mask.sum())
    used = np.unique(info.vertex_orbit[targets_mask])
    n_aorb = len(info.arc_sizes)
    orbit_sums = np.zeros(n_aorb, dtype=np.float64)
    dist_sum = 0.0
    diam = 0
    for orb in used:
        rep = int(info.vertex_reps[orb])
        size = float(info.vertex_sizes[orb])
        loads_r, dsum_r, _, diam_r = _loads(g, np.array([rep]), targets_mask,
                                            None, engine, device)
        orbit_sums += size * np.bincount(info.arc_orbit, weights=loads_r,
                                         minlength=n_aorb)
        dist_sum += size * dsum_r
        diam = max(diam, diam_r)
    loads = orbit_sums[info.arc_orbit] / info.arc_sizes[info.arc_orbit]
    pair_count = t_count * (t_count - 1)
    return loads, dist_sum, pair_count, diam


def _prepare(engine, device):
    device = resolve_device(device)
    return _engine_name(engine), resolve_engine(engine, device), device


def arc_loads(g: Graph, sources=None, targets_mask: np.ndarray | None = None,
              engine: str | None = None, device=None
              ) -> tuple[np.ndarray, float, int]:
    """Per-arc load under uniform traffic, plus (k̄, diameter) of the pairs
    used.

    ``sources`` defaults to every vertex (or every target if
    ``targets_mask`` is given); traffic flows from each source to every
    other target vertex, 1 unit per ordered pair, split across shortest
    paths.  ``engine`` is ``auto``, ``dense``, ``fused`` or ``orbit`` (see
    the module docstring; None takes the ``util_engine`` flag); ``orbit``
    raises where the shortcut does not apply, ``auto`` takes it only with
    the default sources and the ``util_orbits`` flag on."""
    name, eng, device = _prepare(engine, device)
    n = g.n
    if targets_mask is None:
        targets_mask = np.ones(n, dtype=bool)
    else:
        targets_mask = np.asarray(targets_mask, dtype=bool)
    default_sources = sources is None
    if sources is None:
        sources = np.nonzero(targets_mask)[0]
    sources = np.asarray(sources, dtype=np.int64)
    res = None
    with obs.span("util.arc_loads", engine=name, n=g.n):
        obs.counter(f"util.dispatch[{name}]").add(1.0)
        if name in ("auto", "orbit"):
            obs.counter(f"util.engine[{eng}]").add(1.0)
            if default_sources and (name == "orbit"
                                    or flags().util_orbits):
                res = _loads_orbit(g, targets_mask, eng, device)
                if res is not None:
                    obs.counter("util.engine[orbit]").add(1.0)
        if res is None:
            if name == "orbit":
                raise ValueError(
                    f"no known automorphism generators for "
                    f"{g.name or g.meta.get('family')!r}"
                    " (or sources/targets not orbit-compatible)")
            res = _loads(g, sources, targets_mask, None, eng, device)
    loads, dist_sum, pair_count, diam = res
    return loads, dist_sum / pair_count, diam


def _uniform_demand_split(demand: np.ndarray):
    """Detect a uniform-shaped demand: ``w * (ones - I)`` on some active
    vertex set, zero elsewhere.  Returns ``(w, active_mask)`` or None.

    Such a matrix commutes with the graph's full automorphism group (any
    subgroup preserving the active set), so the orbit shortcut of
    :func:`arc_loads` applies: the weighted sweep reduces to the uniform
    one scaled by w."""
    rows = demand.any(axis=1)
    if not np.array_equal(rows, demand.any(axis=0)):
        return None
    active = np.nonzero(rows)[0]
    if len(active) < 2:
        return None
    block = demand[np.ix_(active, active)]
    w = block[0, 1]
    if w <= 0.0:
        return None
    expect = np.full(block.shape, w)
    np.fill_diagonal(expect, 0.0)
    if not np.array_equal(block, expect):
        return None
    return w, rows


def arc_loads_weighted(g: Graph, demand, engine: str | None = None,
                       device=None) -> tuple[np.ndarray, float, int]:
    """Per-arc load under an arbitrary traffic matrix, split across all
    shortest paths.

    ``demand[s, t]`` is the traffic s injects for t (any nonnegative
    units); the diagonal is ignored.  A TrafficPattern (anything with a
    ``demand(g)`` method) is built against ``g``.  Returns ``(loads,
    kbar, diameter)`` where ``kbar`` is the demand-weighted mean hop
    count ``sum(D * dist) / sum(D)`` and ``diameter`` the longest hop
    count any demand travels.  The uniform case ``D = ones - I``
    reproduces :func:`arc_loads`.  Under ``auto`` / ``orbit`` a
    uniform-shaped demand (``w * (ones - I)`` over an active set, the
    only matrices the automorphism shortcut is exact for) goes through
    the orbit path of :func:`arc_loads` scaled by w; anything else, and
    a family without generators, runs the exact engine."""
    name, eng, device = _prepare(engine, device)
    n = g.n
    if hasattr(demand, "demand") and callable(demand.demand):
        demand = demand.demand(g)  # TrafficPattern duck-type
    demand = np.array(demand, dtype=np.float64)  # private copy, diag zeroed
    if demand.shape != (n, n):
        raise ValueError(f"demand must be ({n}, {n}), got {demand.shape}")
    if not np.isfinite(demand).all():
        raise ValueError("demand must be finite")
    if (demand < 0).any():
        raise ValueError("demand must be nonnegative")
    np.fill_diagonal(demand, 0.0)
    if float(demand.sum()) == 0.0:
        raise ValueError("demand matrix is all zero")
    if name == "orbit" or (name == "auto" and flags().util_orbits):
        uni = _uniform_demand_split(demand)
        if uni is not None:
            w, mask = uni
            try:
                loads, kbar, diam = arc_loads(g, targets_mask=mask,
                                              engine=name, device=device)
            except ValueError:
                # engine="orbit" on a family without known generators:
                # the exact engine runs instead of raising
                pass
            else:
                return loads * w, kbar, diam
    sources = np.nonzero(demand.any(axis=1))[0]
    targets_mask = np.ones(n, dtype=bool)
    with obs.span("util.arc_loads_weighted", engine=name, n=g.n):
        obs.counter(f"util.dispatch[{name}]").add(1.0)
        if name in ("auto", "orbit"):
            obs.counter(f"util.engine[{eng}]").add(1.0)
        loads, dist_sum, total_demand, diam = _loads(
            g, sources, targets_mask, demand, eng, device)
    return loads, dist_sum / total_demand, diam


def utilization(g: Graph, sources=None, targets_mask: np.ndarray | None = None,
                engine: str | None = None, device=None
                ) -> UtilizationReport:
    """The paper's u = mean/max arc load at saturation; traffic is
    restricted to the graph's leaf mask where it has one."""
    if targets_mask is None:
        targets_mask = g.meta.get("leaf_mask")
    loads, kbar, diam = arc_loads(g, sources, targets_mask, engine=engine,
                                  device=device)
    mx = float(loads.max())
    mean = float(loads.mean())
    return UtilizationReport(u=mean / mx, mean_load=mean, max_load=mx,
                             loads=loads, kbar=kbar, diameter=diam)


def valiant_report(g: Graph, sources=None, engine: str | None = None,
                   device=None) -> UtilizationReport:
    """Valiant two-phase randomized routing: every packet goes s ->
    (uniform random intermediate) -> t via minimal paths.  Each phase is
    one uniform-traffic ensemble, so the expected per-arc load is 2x the
    minimal load, u is unchanged and the path length is 2·k̄."""
    rep = utilization(g, sources, engine=engine, device=device)
    return UtilizationReport(u=rep.u, mean_load=rep.mean_load * 2.0,
                             max_load=rep.max_load * 2.0,
                             loads=rep.loads * 2.0, kbar=2.0 * rep.kbar,
                             diameter=rep.diameter)
