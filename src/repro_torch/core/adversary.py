"""Adversarial traffic evaluation: the worst pattern per (topology, model).

PolarFly (arXiv:2208.01695) and LACIN (arXiv:2601.05668) both evaluate
their topologies under an adaptive-routing adversarial regime: for each
candidate network, report saturation throughput under a battery of named
patterns plus the worst permutation a search can find, for minimal,
Valiant, AND adaptive (UGAL) routing.  This module reproduces that
comparison for the paper's families:

``worst_case(g, model)``
    Searches the traffic-pattern registry plus ``n_random`` sampled
    permutations for the theta-minimizing pattern under one routing
    model.  theta = 1/max_load with demand normalized to one unit per
    busiest source (the traffic module's semantics throughout).

``adversarial_report(g, patterns, models)``
    The per-topology slab of the PolarFly-style table: theta for every
    (pattern, model) cell, sharing the minimal/Valiant sweeps across the
    models built from them (UGAL adds only its breakpoint scan), plus a
    ``worst_perm`` row per model over the sampled permutations.

``adversarial_table(cases, ...)``
    The full table over named topologies (``benchmarks/routing_bench.py``
    in the reference package, BENCH_3.json).

The searched permutations are seeded ``random_permutation(seed)``
patterns, so any worst-case found is reproducible by name; the named
adversaries (tornado, transpose, bit_reversal, shift) are the structured
patterns the literature reports, and on the paper's arc-transitive
PN/demi-PN families the random search confirms their flatness — theta
barely moves across permutations — while torus/dragonfly collapse.

The port's counterpart of ``repro.core.adversary``: every sweep runs on
the port's arc-load engines (``engine`` ``auto`` / ``fused`` / ``dense``
/ ``orbit``), on the card unless ``device="cpu"`` is passed.  Under an
obs session, as in the reference: ``worst_case`` is an
``adversary.search`` span, and each candidate an ``adversary.candidate``
span counted in ``adversary.candidates`` and streamed as a
``Progress("adversary.candidates")`` record.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import obs
from .._device import resolve_device
from .graph import Graph
from .routing import evaluate_models, make_routing
from .traffic import make_pattern, normalize_demand

__all__ = [
    "AdversaryReport", "worst_case", "adversarial_report",
    "adversarial_table", "DEFAULT_ADVERSARY_PATTERNS", "DEFAULT_MODELS",
]

DEFAULT_ADVERSARY_PATTERNS = ("uniform", "tornado", "transpose", "shift(1)",
                              "bit_reversal")
DEFAULT_MODELS = ("minimal", "valiant", "ugal")


@dataclass
class AdversaryReport:
    """Worst pattern found for one (graph, routing model)."""

    routing: str
    worst_pattern: str
    worst_theta: float
    thetas: dict[str, float] = field(repr=False)   # pattern spec -> theta
    alphas: dict[str, float | None] = field(repr=False, default_factory=dict)


def _active_and_mask(g: Graph, targets_mask):
    """Resolve the active vertex set.  ``targets_mask`` may be a boolean
    (N,) mask or an integer array of vertex ids (e.g. a Placement's
    occupied routers, as the reference's fabric.placement passes them to
    score how robust a job's router set is to hostile tenant traffic)."""
    if targets_mask is None:
        targets_mask = g.meta.get("leaf_mask")
    if targets_mask is None:
        return np.arange(g.n), None
    targets_mask = np.asarray(targets_mask)
    if targets_mask.dtype != bool:
        ids = np.unique(targets_mask.astype(np.int64))
        mask = np.zeros(g.n, dtype=bool)
        mask[ids] = True
        return ids, mask
    return np.nonzero(targets_mask)[0], targets_mask


def _candidate_specs(patterns, n_random: int, seed: int):
    """Named patterns plus seeded random permutations; every candidate is
    a registry spec string, so a worst case found is reproducible by
    name."""
    rng = np.random.default_rng(seed)
    randoms = [f"random_permutation({int(s)})"
               for s in rng.integers(0, 2**31 - 1, size=n_random)]
    return list(patterns), randoms


def _evaluate_specs(g, specs, models, engine, targets_mask, faults=None,
                    device=None):
    """{spec: {model: RoutingResult}} with demand built and normalized
    once per spec and the minimal/Valiant sweeps shared across models.

    With ``faults`` (a :class:`repro_torch.core.faults.FaultSet`), demand
    is still built and normalized on the PRISTINE graph — degraded theta
    stays in pristine busiest-source units — then restricted to the
    survivors and evaluated on the degraded graph (the fault model's
    semantics)."""
    active, mask = _active_and_mask(g, targets_mask)
    if faults is not None and not faults.empty:
        gd = faults.apply(g)
        act_d = faults.restrict_active(g, mask)
        if len(act_d) < 2:
            raise ValueError("fewer than 2 active vertices survive the "
                             "faults")
        out = {}
        prog = obs.Progress("adversary.candidates", total=len(specs))
        for spec in specs:
            obs.counter("adversary.candidates").add(1.0)
            with obs.span("adversary.candidate", pattern=str(spec),
                          faulted=True):
                demand = normalize_demand(make_pattern(spec).demand(g, mask))
                dem = faults.restrict_demand(g, demand)
                if dem.sum() <= 0:
                    raise ValueError(
                        f"faults removed every demand of {spec!r}")
                out[spec] = evaluate_models(gd, dem, act_d, models, engine,
                                            device)
            prog.step(pattern=str(spec), faulted=True)
        return out
    out = {}
    prog = obs.Progress("adversary.candidates", total=len(specs))
    for spec in specs:
        obs.counter("adversary.candidates").add(1.0)
        with obs.span("adversary.candidate", pattern=str(spec)):
            demand = normalize_demand(make_pattern(spec).demand(g, mask))
            out[spec] = evaluate_models(g, demand, active, models, engine,
                                        device)
        prog.step(pattern=str(spec))
    return out


def worst_case(g: Graph, model="minimal",
               patterns=DEFAULT_ADVERSARY_PATTERNS, n_random: int = 8,
               seed: int = 0, engine: str | None = None,
               targets_mask=None, faults=None,
               device=None) -> AdversaryReport:
    """theta-minimizing pattern for one routing model: the named battery
    plus ``n_random`` seeded permutations.  ``faults`` (a FaultSet)
    evaluates every candidate on the degraded graph — the worst pattern
    of a wounded fabric."""
    device = resolve_device(device)
    named, randoms = _candidate_specs(patterns, n_random, seed)
    spec = make_routing(model)  # validate before paying for sweeps
    with obs.span("adversary.search", routing=spec.name,
                  candidates=len(named) + len(randoms)):
        results = _evaluate_specs(g, named + randoms, [model], engine,
                                  targets_mask, faults=faults, device=device)
    thetas = {s: 1.0 / r[model].max_load for s, r in results.items()}
    alphas = {s: r[model].alpha for s, r in results.items()}
    worst = min(thetas, key=thetas.get)
    return AdversaryReport(routing=spec.name, worst_pattern=worst,
                           worst_theta=thetas[worst], thetas=thetas,
                           alphas=alphas)


def adversarial_report(g: Graph, patterns=DEFAULT_ADVERSARY_PATTERNS,
                       models=DEFAULT_MODELS, n_random: int = 8,
                       seed: int = 0, engine: str | None = None,
                       targets_mask=None, faults=None, device=None):
    """One topology's slab of the PolarFly-style table.

    Returns ``(rows, worst)`` where ``rows`` is a list of dicts — one per
    (pattern, model) cell over the named patterns plus a ``worst_perm``
    pseudo-pattern per model (the theta-minimizing sampled permutation,
    with the realizing spec recorded) — and ``worst`` maps each model to
    its overall min theta across every candidate evaluated."""
    device = resolve_device(device)
    named, randoms = _candidate_specs(patterns, n_random, seed)
    results = _evaluate_specs(g, named + randoms, list(models), engine,
                              targets_mask, faults=faults, device=device)

    rows = []
    for spec in named:
        for model in models:
            r = results[spec][model]
            row = {"pattern": spec, "routing": r.routing,
                   "theta": 1.0 / r.max_load, "kbar_eff": r.kbar_eff}
            if r.alpha is not None:
                row["alpha"] = r.alpha
            rows.append(row)
    worst = {}
    for model in models:
        name = make_routing(model).name
        all_thetas = {s: 1.0 / results[s][model].max_load
                      for s in named + randoms}
        worst[name] = {"min_theta": min(all_thetas.values()),
                       "worst_pattern": min(all_thetas, key=all_thetas.get)}
        if randoms:
            rand_thetas = {s: all_thetas[s] for s in randoms}
            worst_rand = min(rand_thetas, key=rand_thetas.get)
            r = results[worst_rand][model]
            row = {"pattern": "worst_perm", "routing": r.routing,
                   "theta": rand_thetas[worst_rand], "kbar_eff": r.kbar_eff,
                   "realized_by": worst_rand, "searched": len(randoms)}
            if r.alpha is not None:
                row["alpha"] = r.alpha
            rows.append(row)
    return rows, worst


def adversarial_table(cases, patterns=DEFAULT_ADVERSARY_PATTERNS,
                      models=DEFAULT_MODELS, n_random: int = 8,
                      seed: int = 0, engine: str | None = None,
                      faults=None, device=None):
    """The full adversarial comparison: ``cases`` is an iterable of
    ``(name, graph)`` pairs (the reference's benchmarks/routing_bench.py
    holds the paper's PN/demi-PN/OFT vs torus/dragonfly line-up).  Returns
    ``{name: {"n": N, "rows": [...], "worst": {model: {...}}}}``.
    ``faults`` applies one FaultSet to every case (the table of a shared
    failure scenario); per-case fault sets belong in separate calls."""
    table = {}
    for name, g in cases:
        rows, worst = adversarial_report(g, patterns=patterns, models=models,
                                         n_random=n_random, seed=seed,
                                         engine=engine, faults=faults,
                                         device=device)
        table[name] = {"n": g.n, "rows": rows, "worst": worst}
    return table
