"""The port's routing models and saturation reports
(repro_torch.core.routing, repro_torch.core.traffic) against the
reference's, on the CPU in float64.

Every pattern of ``DEFAULT_SWEEP`` under every routing model on PN(5),
through both port engines (``dense`` and ``fused``), against the
reference's ``numpy`` engine: theta, u, kbar_eff and alpha at rel 1e-9
(the sweeps sum in different orders; alpha is the argmin of a piecewise
linear envelope, so it moves only by that round-off), the diameter
exactly.  ``blend_optimum`` is the same numpy code on the same inputs,
so its results must be identical.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import pn_graph
from repro.core.routing import blend_optimum as ref_blend_optimum
from repro.core.routing import evaluate_models as ref_evaluate_models
from repro.core.traffic import DEFAULT_SWEEP as REF_DEFAULT_SWEEP
from repro.core.traffic import saturation_report as ref_report
from repro.core.traffic import saturation_sweep as ref_battery
from repro.fabric.model import torus3d_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import (DEFAULT_SWEEP, ROUTINGS, RoutingModel,
                              RoutingResult, blend_optimum, evaluate_models,
                              make_routing, normalize_demand,
                              register_routing, saturation_report)
from repro_torch.core import make_pattern, routing as routing_mod
from repro_torch.core import traffic as traffic_mod

ROUTING_SPECS = ["minimal", "valiant", "ugal", "ugal_threshold(0)",
                 "ugal_threshold(inf)"]


def _port(g):
    return graph_from_arrays(g.n, g.edges, g.meta, name=g.name)


PN5_REF = pn_graph(5)
PN5 = _port(PN5_REF)
TORUS_REF = torus3d_graph(8, 16, 1)
TORUS = _port(TORUS_REF)
SMALL_TORUS_REF = torus3d_graph(4, 4, 1)
SMALL_TORUS = _port(SMALL_TORUS_REF)


def _assert_report(got, want):
    assert got.pattern == want.pattern and got.routing == want.routing
    for key in ("theta", "u", "max_load", "mean_load", "kbar_eff",
                "total_demand"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=1e-9), key
    assert got.diameter == want.diameter
    if want.alpha is None:
        assert got.alpha is None
    else:
        assert got.alpha == pytest.approx(want.alpha, rel=1e-9, abs=1e-12)
    np.testing.assert_allclose(got.loads, want.loads, rtol=1e-9, atol=1e-9)


def test_default_sweep_is_the_reference_battery():
    assert DEFAULT_SWEEP == REF_DEFAULT_SWEEP


@pytest.mark.parametrize("routing", ROUTING_SPECS)
@pytest.mark.parametrize("pattern", DEFAULT_SWEEP)
def test_saturation_report_matches_reference(pattern, routing):
    want = ref_report(PN5_REF, pattern, routing=routing, engine="numpy")
    for engine in ("dense", "fused"):
        got = saturation_report(PN5, pattern, routing=routing,
                                engine=engine, device="cpu")
        _assert_report(got, want)


def test_ugal_strictly_interior_on_tornado_torus():
    """Tornado on an 8x16 torus: the ugal optimum lies strictly between
    the pure routings, and the port finds the same blend."""
    want = ref_report(TORUS_REF, "tornado", routing="ugal", engine="numpy")
    got = saturation_report(TORUS, "tornado", routing="ugal",
                            engine="fused", device="cpu")
    assert 0.0 < got.alpha < 1.0
    _assert_report(got, want)


def test_ugal_source_matches_reference():
    """The per-source LP: its theta is unique (the LP's optimum), so it
    must match; the blend weights may sit on another optimal vertex."""
    for spec in ("tornado", "hot_region(0.25,4)"):
        want = ref_report(SMALL_TORUS_REF, spec, routing="ugal(source)",
                          engine="numpy")
        got = saturation_report(SMALL_TORUS, spec, routing="ugal(source)",
                                engine="fused", device="cpu")
        glob = saturation_report(SMALL_TORUS, spec, routing="ugal",
                                 engine="fused", device="cpu")
        assert got.routing == "ugal(source)"
        assert got.theta == pytest.approx(want.theta, rel=1e-9)
        assert got.theta >= glob.theta - 1e-9
        assert 0.0 <= got.alpha <= 1.0


def test_ugal_source_guard_on_large_graphs(monkeypatch):
    monkeypatch.setattr(routing_mod, "UGAL_SOURCE_MAX_N", 8)
    with pytest.raises(ValueError, match="smaller instance"):
        saturation_report(PN5, "tornado", routing="ugal(source)",
                          device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_blend_optimum_identical_to_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 400))
    l_min = rng.random(n) * 4.0
    l_val = rng.random(n) * 4.0
    assert blend_optimum(l_min, l_val) == ref_blend_optimum(l_min, l_val)


@pytest.mark.parametrize("l_min,l_val", [
    ([1.0, 2.0, 0.5], [2.0, 4.0, 1.0]),     # uniform identity: minimal
    ([5.0, 6.0], [1.0, 1.0]),               # minimal dominated: valiant
    ([0.0, 2.0], [2.0, 0.0]),               # interior breakpoint
])
def test_blend_optimum_endpoint_cases(l_min, l_val):
    l_min, l_val = np.array(l_min), np.array(l_val)
    got = blend_optimum(l_min, l_val)
    assert got == ref_blend_optimum(l_min, l_val)
    assert 0.0 <= got[0] <= 1.0


def test_evaluate_models_matches_reports_and_reference():
    demand = normalize_demand(make_pattern("tornado").demand(TORUS, None))
    active = np.arange(TORUS.n)
    out = evaluate_models(TORUS, demand, active, engine="dense",
                          device="cpu")
    ref = ref_evaluate_models(TORUS_REF, demand, active, engine="numpy")
    assert set(out) == {"minimal", "valiant", "ugal"}
    for model in ("minimal", "valiant", "ugal"):
        rep = saturation_report(TORUS, "tornado", routing=model,
                                engine="dense", device="cpu")
        assert np.array_equal(out[model].loads, rep.loads), model
        np.testing.assert_allclose(out[model].loads, ref[model].loads,
                                   rtol=1e-9, atol=1e-9)


def test_registry_and_spec_parsing():
    assert set(ROUTINGS) == {"minimal", "valiant", "ugal",
                             "ugal_threshold"}
    assert make_routing("ugal(source)").name == "ugal(source)"
    assert make_routing(" ugal_threshold( 16 ) ").name == \
        "ugal_threshold(16)"
    assert make_routing("ugal_threshold(inf)").name == "ugal_threshold(inf)"
    model = make_routing("minimal")
    assert make_routing(model) is model
    with pytest.raises(ValueError, match="unknown routing model"):
        make_routing("adaptive")
    with pytest.raises(ValueError, match="granularity"):
        make_routing("ugal(arc)")
    with pytest.raises(ValueError, match="threshold"):
        make_routing("ugal_threshold(-1)")
    # the pattern registry parses through the same function
    assert traffic_mod.parse_spec is routing_mod.parse_spec
    assert make_pattern("shift(3)").name == "shift(3)"


def test_custom_model_routes_through_saturation_report():
    seen = []

    @register_routing("_test_double_minimal")
    def _factory(scale: float = 2.0) -> RoutingModel:
        def evaluate(g, demand, active, engine="auto", device=None):
            seen.append((engine, str(device)))
            base = make_routing("minimal").evaluate(g, demand, active,
                                                    engine, device)
            return RoutingResult("double", base.loads * scale,
                                 base.kbar_eff, base.diameter)
        return RoutingModel("double", evaluate, "scaled minimal")

    try:
        rep = saturation_report(PN5, "uniform",
                                routing="_test_double_minimal(4)",
                                engine="fused", device="cpu")
        base = saturation_report(PN5, "uniform", engine="fused",
                                 device="cpu")
    finally:
        del ROUTINGS["_test_double_minimal"]
    assert seen == [("fused", "cpu")]
    assert rep.theta == pytest.approx(base.theta / 4.0, rel=1e-15)


def test_faults_wait_for_their_port():
    """The fault model is ported now: ``saturation_report(faults=)``
    delegates to the port's ``degraded_report`` and equals the
    reference's degraded theta; an empty fault set is the pristine
    report."""
    from repro.core import FaultSet as RefFaultSet
    from repro_torch.convert import fault_set_from_arrays
    from repro_torch.core import FaultSet
    ref_fs = RefFaultSet(links=[tuple(map(int, PN5_REF.edges[3]))],
                         routers=[7])
    fs = fault_set_from_arrays(ref_fs.links, ref_fs.routers)
    want = ref_report(PN5_REF, "uniform", routing="ugal", engine="numpy",
                      faults=ref_fs)
    for engine in ("dense", "fused"):
        got = saturation_report(PN5, "uniform", routing="ugal",
                                engine=engine, faults=fs, device="cpu")
        _assert_report(got, want)
        assert got.faults == want.faults == fs.label
    pristine = saturation_report(PN5, "uniform", faults=FaultSet(),
                                 device="cpu")
    assert pristine.faults is None


def test_saturation_sweep_battery_matches_reference():
    reports, summary = traffic_mod.saturation_sweep(
        PN5, routings=("minimal", "valiant", "ugal"), engine="fused",
        device="cpu")
    ref_reports, ref_summary = ref_battery(
        PN5_REF, routings=("minimal", "valiant", "ugal"), engine="numpy")
    assert len(reports) == len(DEFAULT_SWEEP) * 3
    for got, want in zip(reports, ref_reports):
        _assert_report(got, want)
    for r, row in ref_summary.items():
        assert summary[r]["worst_pattern"] == row["worst_pattern"]
        assert summary[r]["min_theta"] == pytest.approx(row["min_theta"],
                                                        rel=1e-9)
        assert summary[r]["worst_u"] == pytest.approx(row["worst_u"],
                                                      rel=1e-9)
