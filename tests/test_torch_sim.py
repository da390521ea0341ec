"""repro_torch.sim against repro.sim, step for step, on the CPU in
float64.

* the dense step against the reference's ``backend="numpy"`` (the dense
  float64 oracle);
* the fused step against the reference's ``backend="pallas",
  dtype="float64"`` (its blocked numpy mirror on the CPU) — never
  against the reference's jax paths, whose float64 mode is dead on the
  installed jax;
* SimRun measurements and a short per-dest saturation sweep;
* the two finite-buffer overload cases in which the reference's PEND
  drain goes non-finite: the port stays finite and conserving, and
  matches the reference for every step before the reference blows up.

Per-step histories must agree at rtol 1e-9 (atol 1e-12): both sides run
the same float64 algebra in different summation orders, and the UGAL
threshold rule can only amplify that round-off through a decision flip.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import pn_graph as ref_pn_graph
from repro.core.traffic import make_pattern as ref_make_pattern
from repro.core.traffic import normalize_demand
from repro.core.traffic import saturation_report as ref_saturation_report
from repro.fabric.model import torus3d_graph
from repro.sim import SimConfig as RefConfig
from repro.sim import Simulator as RefSimulator
from repro.sim import saturation_sweep as ref_sweep
from repro.sim import simulate as ref_simulate
from repro_torch.convert import (graph_from_arrays, state_from_numpy,
                                 state_to_numpy)
from repro_torch.sim import (SimConfig, Simulator, saturation_sweep,
                             simulate)
from repro_torch.sim.engine import pick_backend

KEYS = ("delivered", "accepted", "offered", "occupancy", "src_backlog",
        "diverted")


def _port(g):
    return graph_from_arrays(g.n, g.edges, g.meta, name=g.name)


PN7_REF = ref_pn_graph(7)
PN7 = _port(PN7_REF)
TORUS_REF = torus3d_graph(8, 16, 1)
TORUS = _port(TORUS_REF)
SMALL_REF = torus3d_graph(4, 4, 1)
SMALL = _port(SMALL_REF)

CASES = {"pn7_uniform": (PN7_REF, PN7, "uniform", 0.7),
         "torus8x16_tornado": (TORUS_REF, TORUS, "tornado", 0.38)}
ROUTINGS = ["minimal", "valiant", "ugal_threshold(0)"]


def _demand(g, spec):
    return normalize_demand(ref_make_pattern(spec).demand(g, None))


def _histories_close(port, ref, rtol=1e-9, atol=1e-12, upto=None):
    for key in KEYS:
        np.testing.assert_allclose(port.history[key][:upto],
                                   ref.history[key][:upto], rtol=rtol,
                                   atol=atol, err_msg=f"history[{key!r}]")


def _pair(g_ref, g, dem, routing, ref_backend, backend, offered, steps=24,
          buffer=float("inf")):
    ref = RefSimulator(g_ref, RefConfig(routing=routing, backend=ref_backend,
                                        dtype="float64", buffer=buffer),
                       demand=dem).run(dem, offered, steps)
    sim = Simulator(g, SimConfig(routing=routing, backend=backend,
                                 dtype="float64", buffer=buffer),
                    demand=dem, device="cpu")
    return sim.run(dem, offered, steps), ref, sim


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_step_matches_reference_numpy(case, routing):
    g_ref, g, spec, offered = CASES[case]
    dem = _demand(g_ref, spec)
    port, ref, sim = _pair(g_ref, g, dem, routing, "numpy", "dense",
                           offered)
    assert sim.backend == "dense" and port.device == "cpu"
    _histories_close(port, ref)
    assert port.residual < 1e-9


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_matches_reference_pallas(case, routing):
    g_ref, g, spec, offered = CASES[case]
    dem = _demand(g_ref, spec)
    port, ref, sim = _pair(g_ref, g, dem, routing, "pallas", "fused",
                           offered)
    assert sim.backend == "fused"
    _histories_close(port, ref)
    assert port.residual < 1e-9


def _neighbor_demand(g, n_cols, seed=0):
    """``n_cols`` random dest columns, each fed equally by its direct
    neighbours (the compacted-adaptive demand of the reference's kernel
    benchmark)."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(g.n, size=n_cols, replace=False))
    dem = np.zeros((g.n, g.n))
    for c in cols:
        dem[g.neighbors(c), c] = 1.0
    return normalize_demand(dem), cols


PN16_REF = ref_pn_graph(16)


@pytest.mark.parametrize("routing,buffer,offered", [
    ("ugal_threshold(0)", 4.0, 6.0),
    ("valiant", 4.0, 6.0),
    ("ugal_threshold(16)", float("inf"), 12.0)])
def test_fused_compacted_matches_reference(routing, buffer, offered):
    """24 neighbour-fed columns of 546 on PN(16) past the knee (5.0), so
    fluid diverts and the compacted q0/q2/src/pend axes carry it."""
    dem, cols = _neighbor_demand(PN16_REF, 24)
    port, ref, sim = _pair(PN16_REF, _port(PN16_REF), dem, routing,
                           "pallas", "fused", offered=offered, steps=24,
                           buffer=buffer)
    np.testing.assert_array_equal(sim.dest_cols, cols)
    assert len(sim.active) == PN16_REF.n     # the active set stays whole
    assert sim.tables.m == PN16_REF.n
    _histories_close(port, ref)
    assert port.residual < 1e-9
    assert port.history["diverted"].sum() > 0


def test_fused_finite_buffer_matches_dense():
    """Fused and dense steps of the port against each other with finite
    buffers under the interior-blend tornado (both decision branches
    live), and the final states equal to round-off."""
    dem = _demand(TORUS_REF, "tornado")
    out = {}
    for backend in ("dense", "fused"):
        sim = Simulator(TORUS, SimConfig(routing="ugal_threshold(0)",
                                         backend=backend, dtype="float64",
                                         buffer=4.0),
                        demand=dem, device="cpu")
        out[backend] = (sim.run(dem, 0.45, 40), sim.last_state)
    (a, sa), (b, sb) = out["dense"], out["fused"]
    _histories_close(b, a)
    assert 0.0 < a.alpha < 1.0
    for x, y in zip(state_to_numpy(sb), state_to_numpy(sa)):
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-12)
    # the state survives a round trip through numpy bit for bit
    back = state_from_numpy(state_to_numpy(sb), device="cpu")
    for x, y in zip(back.as_tuple(), sb.as_tuple()):
        assert x.dtype == y.dtype and bool((x == y).all())


@pytest.mark.parametrize("backend,ref_backend", [("dense", "numpy"),
                                                 ("fused", "pallas")])
def test_simrun_measurements_match_reference(backend, ref_backend):
    dem = _demand(TORUS_REF, "tornado")
    port, ref, _ = _pair(TORUS_REF, TORUS, dem, "ugal_threshold(0)",
                         ref_backend, backend, offered=0.38, steps=60)
    for field in ("theta", "alpha", "latency", "delivered_rate",
                  "accepted_rate", "occupancy"):
        assert getattr(port, field) == pytest.approx(getattr(ref, field),
                                                     rel=1e-9), field
    assert port.residual < 1e-12 and ref.residual < 1e-12
    assert (port.steps, port.window) == (ref.steps, ref.window)


def test_saturation_sweep_per_dest_matches_reference():
    """A short per-dest-knee sweep over 8 neighbour-fed columns of PN(7):
    every probe (grid and bisection) matches the reference's."""
    dem, _ = _neighbor_demand(PN7_REF, 8)
    theta = ref_saturation_report(PN7_REF, dem, routing="ugal").theta
    kw = dict(routing="ugal_threshold(16)",
              loads=np.array([0.96, 1.05]) * theta, steps=30, refine=2,
              stable_ratio=0.998, theta_analytic=theta, knee="per_dest")
    ref = ref_sweep(PN7_REF, dem, config=RefConfig(backend="pallas",
                                                   dtype="float64"), **kw)
    port = saturation_sweep(PN7, dem, config=SimConfig(backend="fused",
                                                       dtype="float64"),
                            device="cpu", **kw)
    assert port.knee == "per_dest" and len(port.runs) == 4
    np.testing.assert_allclose(port.loads, ref.loads, rtol=1e-12)
    np.testing.assert_allclose(port.delivered, ref.delivered, rtol=1e-9)
    assert port.theta == pytest.approx(ref.theta, rel=1e-12)
    assert port.theta_unstable == pytest.approx(ref.theta_unstable,
                                                rel=1e-12)
    assert port.theta < port.theta_unstable < np.inf
    for a, b in zip(port.runs, ref.runs):
        assert a.dest_stability_min == pytest.approx(b.dest_stability_min,
                                                     rel=1e-9, abs=1e-12)
        assert a.dest_stability_mean == pytest.approx(
            b.dest_stability_mean, rel=1e-9, abs=1e-12)


def test_sweep_requires_analytic_theta():
    """Without ``theta_analytic`` the sweep computes the analytic theta
    itself (``saturation_report`` under the matching fluid model, on the
    sweep's device), grids its probes on it and lands on the reference's
    knee: the reference's own sweep, ``backend="numpy"``, does the same.
    Tornado, not uniform: at uniform the grid's probe at exactly 1.0x
    theta sits on the capacity itself, where a one-ulp difference in
    theta decides whether the threshold rule fires."""
    kw = dict(routing="ugal_threshold(0)", steps=24, refine=1)
    ref = ref_sweep(PN7_REF, "tornado",
                    config=RefConfig(backend="numpy", dtype="float64"), **kw)
    port = saturation_sweep(PN7, "tornado",
                            config=SimConfig(backend="dense",
                                             dtype="float64"),
                            device="cpu", **kw)
    theta = ref_saturation_report(PN7_REF, "tornado", routing="ugal").theta
    assert port.theta_analytic == pytest.approx(theta, rel=1e-9)
    assert port.theta_analytic == pytest.approx(ref.theta_analytic,
                                                rel=1e-9)
    assert len(port.runs) == len(ref.runs) == 6
    np.testing.assert_allclose(port.loads, ref.loads, rtol=1e-9)
    np.testing.assert_allclose(port.delivered, ref.delivered, rtol=1e-9)
    assert port.theta == pytest.approx(ref.theta, rel=1e-9)
    assert 0.0 < port.theta < port.theta_unstable < np.inf


def test_compacted_run_rejects_foreign_demand():
    dem, _ = _neighbor_demand(PN16_REF, 24)
    sim = Simulator(_port(PN16_REF), SimConfig(routing="ugal_threshold(0)",
                                               backend="fused",
                                               dtype="float64"),
                    demand=dem, device="cpu")
    assert sim.dest_cols is not None
    with pytest.raises(ValueError, match="compact"):
        sim.run(_demand(PN16_REF, "uniform"), 0.5, 4)


def test_backend_rule_and_validation():
    assert pick_backend("auto", 50_000_001) == "fused"
    assert pick_backend("auto", 50_000_000) == "dense"
    with pytest.raises(ValueError, match="backend"):
        pick_backend("pallas", 10)
    dem = _demand(PN7_REF, "uniform")
    sim = Simulator(PN7, SimConfig(), demand=dem, device="cpu")
    assert sim.backend == "dense" and str(sim.dtype) == "torch.float64"
    sim = Simulator(PN7, SimConfig(backend="fused"), demand=dem,
                    device="cpu")
    assert str(sim.dtype) == "torch.float32"
    with pytest.raises(ValueError, match="diagonal"):
        sim.run(np.eye(PN7.n), 0.5, 4)


# The finite-buffer overload cases in which the reference's PEND row sum
# rounds below zero (torus 4x4, ugal_threshold(0), buffer 2, 60 steps).
# At offered 2.9855 (the recorded, rounded load) the first stays finite in
# the reference too; the second goes non-finite at step 11; the third
# stays finite but ends with the reference's residual at 2.3e-7.  The
# fourth is the draw that tests/test_sim.py::test_flow_conservation_
# hypothesis saved when it failed (seed 20, offered 1.0, buffer 2.0): the
# reference's residual 1.25e-8 there against that test's 1e-12.  The
# fifth is another such saved failing draw (seed 36, offered 1.30078125,
# buffer 2.0), and the sixth one more, drawn afresh (seed 235, offered
# 3.0, buffer 2.0: the reference's residual is NaN there).
CONSERVATION_CASES = [("random_permutation(913171518)", 2.9855),
                      ("random_permutation(266896303)", 1.9592),
                      ("random_permutation(689)", 1.0),
                      ("random_permutation(20)", 1.0),
                      ("random_permutation(36)", 1.30078125),
                      ("random_permutation(235)", 3.0)]


@pytest.mark.parametrize("backend,ref_backend", [("dense", "numpy"),
                                                 ("fused", "pallas")])
@pytest.mark.parametrize("spec,offered", CONSERVATION_CASES)
def test_conservation_where_reference_goes_nonfinite(spec, offered,
                                                     backend, ref_backend):
    cfg = dict(routing="ugal_threshold(0)", steps=60, offered=offered)
    with np.errstate(all="ignore"):
        ref = ref_simulate(SMALL_REF, spec,
                           config=RefConfig(buffer=2.0, backend=ref_backend,
                                            dtype="float64"), **cfg)
    port = simulate(SMALL, spec, config=SimConfig(buffer=2.0,
                                                  backend=backend,
                                                  dtype="float64"),
                    device="cpu", **cfg)
    for key in KEYS:
        assert np.isfinite(port.history[key]).all(), key
    assert port.residual <= 1e-9
    assert port.history["delivered"].sum() <= \
        port.history["offered"].sum() * (1 + 1e-12)
    # the reference stops conserving at the first step its running
    # conservation identity breaks; compare every step before that
    total = normalize_demand(
        ref_make_pattern(spec).demand(SMALL_REF, None)).sum()
    h = ref.history
    with np.errstate(all="ignore"):
        defect = np.abs((np.cumsum(h["offered"]) - np.cumsum(h["delivered"]))
                        * total - h["occupancy"] - h["src_backlog"])
    bad = np.nonzero(~(defect <= 1e-9 * np.cumsum(h["offered"]) * total))[0]
    upto = int(bad[0]) if len(bad) else None
    _histories_close(port, ref, upto=upto)
