"""repro_torch.core.adversary against repro.core.adversary, on the CPU.

Mirrors ``tests/test_adversary.py``'s six tests (worst-case search
semantics, the PolarFly-style table's shape, UGAL's dominance, PN's
flatness against the torus's collapse, the multi-topology table) on the
port, each also held against the reference's ``numpy`` engine on the
same graphs: every theta within rtol 1e-9, and worst patterns and the
``realized_by`` of every ``worst_perm`` row equal by name.  Where the
reference's smallest thetas tie within 1e-9 (Valiant gives every
fixed-point-free permutation the same theta in exact arithmetic),
rounding decides its pick, so there the port's pick must be one of the
tied candidates.  Both port engines run (``dense``; ``auto``, which takes
the orbit shortcut on PN and OFT).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.adversary import adversarial_report as ref_report
from repro.core.adversary import worst_case as ref_worst_case
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
from repro_torch.core.adversary import (DEFAULT_ADVERSARY_PATTERNS,
                                        DEFAULT_MODELS)
from repro_torch.fabric import torus3d_graph

ENGINES = ["dense", "auto"]
TIE = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    # torch on this box is slow multithreaded at tiny sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torus(x, y, z):
    return torus3d_graph(x, y, z), ref_torus3d_graph(x, y, z)


def _pn(q):
    return P.pn_graph(q), R.pn_graph(q)


def _oft(q):
    return P.oft_graph(q), R.oft_graph(q)


def _close(got, want, rtol=1e-9):
    assert got == pytest.approx(want, rel=rtol)


def _tied(thetas: dict, worst: float) -> list:
    return [s for s, th in thetas.items() if th <= worst * (1 + TIE)]


def _same_worst_case(got, want):
    assert got.routing == want.routing
    assert list(got.thetas) == list(want.thetas)
    for spec, theta in want.thetas.items():
        _close(got.thetas[spec], theta)
        assert (got.alphas[spec] is None) == (want.alphas[spec] is None)
    _close(got.worst_theta, want.worst_theta)
    tied = _tied(want.thetas, want.worst_theta)
    assert got.worst_pattern in tied
    if len(tied) == 1:
        assert got.worst_pattern == want.worst_pattern


@functools.cache
def _ref_thetas(build, args, model, n_random, seed):
    """Every candidate's reference theta, for the tie rule."""
    g = build(*args)
    return ref_worst_case(g, model, n_random=n_random, seed=seed,
                          engine="numpy").thetas


def _same_report(got, want, thetas_of, ref_graph):
    """Rows and worst summary of adversarial_report against the
    reference's; ``thetas_of(model)`` gives the reference's theta of
    every candidate.  A ``worst_perm`` row realized by another tied
    permutation is held against the reference's report of that one."""
    rows, worst = got
    ref_rows, ref_worst = want
    assert len(rows) == len(ref_rows)
    for a, b in zip(rows, ref_rows):
        assert set(a) == set(b)
        for key in ("pattern", "routing", "searched"):
            assert a.get(key) == b.get(key)
        if "realized_by" in b:
            randoms = {s: th for s, th in thetas_of(b["routing"]).items()
                       if s.startswith("random_permutation(")}
            tied = _tied(randoms, b["theta"])
            assert a["realized_by"] in tied
            if len(tied) == 1:
                assert a["realized_by"] == b["realized_by"]
            if a["realized_by"] != b["realized_by"]:
                rep = R.saturation_report(ref_graph, a["realized_by"],
                                          routing=b["routing"],
                                          engine="numpy")
                b = {**b, "theta": rep.theta, "kbar_eff": rep.kbar_eff,
                     **({"alpha": rep.alpha} if "alpha" in b else {})}
        for key in ("theta", "kbar_eff", "alpha"):
            if key in b:
                _close(a[key], b[key])
    assert set(worst) == set(ref_worst)
    for model, w in ref_worst.items():
        _close(worst[model]["min_theta"], w["min_theta"])
        tied = _tied(thetas_of(model), w["min_theta"])
        assert worst[model]["worst_pattern"] in tied
        if len(tied) == 1:
            assert worst[model]["worst_pattern"] == w["worst_pattern"]


@pytest.mark.parametrize("engine", ENGINES)
def test_worst_case_finds_registry_minimum(engine):
    g, ref = _torus(8, 8, 1)
    rep = P.worst_case(g, "minimal", n_random=4, engine=engine, device="cpu")
    assert rep.routing == "minimal"
    assert rep.worst_pattern in rep.thetas
    assert rep.worst_theta == min(rep.thetas.values())
    # every candidate's theta is reproducible from its spec string
    check = P.saturation_report(g, rep.worst_pattern, engine=engine,
                                device="cpu")
    assert check.theta == pytest.approx(rep.worst_theta, rel=1e-12)
    # the named battery + 4 sampled permutations were all evaluated
    assert len(rep.thetas) == len(DEFAULT_ADVERSARY_PATTERNS) + 4
    _same_worst_case(rep, ref_worst_case(ref, "minimal", n_random=4,
                                         engine="numpy"))


def test_worst_case_validates_model_spec():
    with pytest.raises(ValueError, match="unknown routing"):
        P.worst_case(torus3d_graph(3, 3, 1), "teleport", n_random=0,
                     device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_adversarial_report_table_shape(engine):
    g, ref = _torus(4, 4, 1)
    rows, worst = P.adversarial_report(g, n_random=3, seed=1, engine=engine,
                                       device="cpu")
    # one row per (named pattern, model) + one worst_perm row per model
    assert len(rows) == ((len(DEFAULT_ADVERSARY_PATTERNS) + 1)
                         * len(DEFAULT_MODELS))
    assert {r["routing"] for r in rows} == set(DEFAULT_MODELS)
    for r in rows:
        assert r["theta"] > 0
        if r["routing"] == "ugal":
            assert 0.0 <= r["alpha"] <= 1.0
        if r["pattern"] == "worst_perm":
            assert r["realized_by"].startswith("random_permutation(")
            assert r["searched"] == 3
    # worst summary is the min over named + sampled candidates
    for model in DEFAULT_MODELS:
        cells = [r["theta"] for r in rows if r["routing"] == model]
        assert worst[model]["min_theta"] <= min(cells) + 1e-12
    _same_report((rows, worst), ref_report(ref, n_random=3, seed=1,
                                           engine="numpy"),
                 lambda m: _ref_thetas(ref_torus3d_graph, (4, 4, 1), m, 3,
                                       1), ref)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", ["torus8x8", "pn3", "oft3"])
def test_ugal_worst_case_dominates_pure_routings(case, engine):
    """UGAL's worst-found theta is at least each pure routing's on every
    pattern, hence also on the worst case; the table is the
    reference's."""
    build, args = {"torus8x8": (ref_torus3d_graph, (8, 8, 1)),
                     "pn3": (R.pn_graph, (3,)),
                     "oft3": (R.oft_graph, (3,))}[case]
    g, ref = {"torus8x8": lambda: _torus(8, 8, 1), "pn3": lambda: _pn(3),
              "oft3": lambda: _oft(3)}[case]()
    rows, worst = P.adversarial_report(g, n_random=3, engine=engine,
                                       device="cpu")
    by = {(r["pattern"], r["routing"]): r["theta"] for r in rows}
    for pattern in DEFAULT_ADVERSARY_PATTERNS:
        pure = max(by[(pattern, "minimal")], by[(pattern, "valiant")])
        assert by[(pattern, "ugal")] >= pure - 1e-9, pattern
    assert worst["ugal"]["min_theta"] >= max(
        worst["minimal"]["min_theta"], worst["valiant"]["min_theta"]) - 1e-9
    _same_report((rows, worst), ref_report(ref, n_random=3, engine="numpy"),
                 lambda m: _ref_thetas(build, args, m, 3, 0), ref)


def test_pn_flat_torus_collapses_under_permutations():
    """The paper's balance claim, adversarially: minimal-routing theta on
    arc-transitive PN stays within a small band across sampled
    permutations, while the 2D torus's tornado collapses it well below
    its uniform theta."""
    pn, pn_ref = _pn(4)
    rep = P.worst_case(pn, "minimal", n_random=6, device="cpu")
    perm_thetas = [v for k, v in rep.thetas.items()
                   if k.startswith("random_permutation")]
    assert max(perm_thetas) / min(perm_thetas) < 2.5
    _same_worst_case(rep, ref_worst_case(pn_ref, "minimal", n_random=6,
                                         engine="numpy"))
    torus, torus_ref = _torus(8, 8, 1)
    uni = P.saturation_report(torus, "uniform", device="cpu").theta
    tor = P.worst_case(torus, "minimal", n_random=2, device="cpu")
    assert tor.worst_theta < 0.5 * uni
    _same_worst_case(tor, ref_worst_case(torus_ref, "minimal", n_random=2,
                                         engine="numpy"))


def test_adversarial_table_runs_multiple_topologies():
    (torus, torus_ref), (pn3, pn3_ref) = _torus(4, 4, 1), _pn(3)
    cases = [("torus", torus), ("pn3", pn3)]
    table = P.adversarial_table(cases, n_random=2,
                                patterns=("uniform", "tornado"),
                                device="cpu")
    want = R.adversarial_table([("torus", torus_ref), ("pn3", pn3_ref)],
                               n_random=2, patterns=("uniform", "tornado"),
                               engine="numpy")
    assert set(table) == {"torus", "pn3"}
    for name, slab in table.items():
        assert slab["n"] == dict(cases)[name].n == want[name]["n"]
        assert set(slab["worst"]) == set(DEFAULT_MODELS)
        for a, b in zip(slab["rows"], want[name]["rows"]):
            assert (a["pattern"], a["routing"]) == (b["pattern"],
                                                    b["routing"])
            _close(a["theta"], b["theta"])


def test_adversary_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = P.pn_graph(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.worst_case(g, n_random=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.adversarial_report(g, n_random=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.adversarial_table([("pn2", g)], n_random=0)
    rep = P.worst_case(g, n_random=0, device="cpu")
    assert rep.worst_theta == pytest.approx(min(rep.thetas.values()))
    assert np.isfinite(rep.worst_theta)
