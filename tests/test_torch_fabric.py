"""repro_torch.fabric (collectives, FabricModel, the planner),
``repro_torch.sim.simulate_placement`` and ``repro_torch.placement_tables``
against the reference, on the CPU.

Ports the three fabric tests of ``tests/test_system.py`` (collective
consistency, the planner's demi-PN-before-Slim-Fly ranking, the torus
reference point), ``tests/test_sim.py::test_simulate_placement`` and the
BENCH_4 table (``benchmarks/placement_bench.py``) on its three small
cases.  The same inputs go through both packages (the port on
``device="cpu"``):

* collective times: exact;
* k̄, u, thetas, ``kbar_eff``: rtol 1e-9 against the reference's exact
  ``numpy`` engine; the planner's rounded rows equal;
* ``simulate_placement``: against the reference's ``backend="numpy"``
  (the port's dense step) and ``backend="pallas", dtype="float64"`` (the
  port's fused step) at rtol 1e-9; per-hop ugal_threshold(0) at 0.9x the
  fluid theta of an EP-heavy placement on PN(7) and PN(8), both steps
  against the reference's ``numpy`` run at 144 and 432 steps, whose
  readings are recorded;
* BENCH_4's rows: equal to the reference's ``placement_one`` rows
  (thetas and u to the recorded six digits, ``max_bytes`` and ``alpha``
  at rtol 1e-9), and within 1e-6 of ``BENCH_4.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.fabric as RF
import repro_torch.core as P
import repro_torch.fabric as PF
from benchmarks import placement_bench as ref_bench
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
from repro.perf import flags as ref_flags
from repro.perf import set_flags as ref_set_flags
from repro.sim import SimConfig as RefConfig
from repro.sim import simulate_placement as ref_simulate_placement
from repro_torch import placement_tables
from repro_torch.convert import placement_from_arrays
from repro_torch.sim import SimConfig, simulate_placement

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    # torch runs these tiny sizes faster on one thread
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_numpy_engine():
    """The reference's calls that take no engine (the planner, its
    FabricModel) run its exact ``numpy`` engine (its ``auto`` reaches the
    float64 jax path, dead on the installed jax)."""
    old = ref_flags().util_engine
    ref_set_flags(util_engine="numpy")
    yield
    ref_set_flags(util_engine=old)


def _close(got, want, rtol=1e-9):
    assert got == pytest.approx(want, rel=rtol)


# ---------------------------------------------------------------------------
# Collectives and FabricModel
# ---------------------------------------------------------------------------


def _fabric_pair(kind, args, delta0):
    fab = PF.make_fabric(kind, args=args, terminals_per_router=delta0,
                         device="cpu")
    ref = RF.make_fabric(kind, args=args, terminals_per_router=delta0)
    assert fab.name == ref.name
    _close(fab.kbar, ref.kbar)
    _close(fab.u, ref.u)
    return fab, ref


def test_fabric_collective_model_consistency():
    fab, ref = _fabric_pair("demi_pn", (9,), 5)
    n, b = 100, 1e9
    ar = PF.allreduce_time(fab, b, n)
    rs = PF.reducescatter_time(fab, b, n)
    ag = PF.allgather_time(fab, b, n)
    assert ar.total_s == pytest.approx(rs.total_s + ag.total_s)
    assert PF.allgather_time(fab, 2 * b, n).bandwidth_s == pytest.approx(
        2 * ag.bandwidth_s)
    # exact against the reference on the same k̄ and u
    ref_same = RF.FabricModel(ref.graph, terminals_per_router=5,
                              kbar=fab.kbar, u=fab.u)
    for op in PF.collectives.RING_OPS + PF.collectives.SPREAD_OPS:
        for n_ranks in (1, 2, 100):
            got = PF.collective_time(fab, op, b, n_ranks)
            want = RF.collective_time(ref_same, op, b, n_ranks)
            assert (got.op, got.bytes_per_node, got.bandwidth_s,
                    got.latency_s) == (want.op, want.bytes_per_node,
                                       want.bandwidth_s, want.latency_s)
            assert PF.bytes_on_wire(op, b, n_ranks) \
                == RF.bytes_on_wire(op, b, n_ranks)
    with pytest.raises(ValueError, match="unknown collective"):
        PF.bytes_on_wire("broadcast", b, n)


@pytest.mark.parametrize("pattern,routing", [
    ("tornado", "minimal"), ("tornado", "ugal"), ("uniform", "valiant"),
    ("uniform", "ugal_threshold(2)"), ("hot_region(0.2,4)", "valiant")])
def test_pattern_pricing_matches_reference(pattern, routing):
    """Pattern-priced collectives: theta and kbar_eff of the pattern
    replace Eq. 1's uniform figures (uniform keeps the fabric's own
    convention, halved under Valiant)."""
    fab, ref = _fabric_pair("demi_pn", (7,), 4)
    _close(fab.pattern_node_bw(pattern, routing),
           ref.pattern_node_bw(pattern, routing))
    _close(fab.pattern_kbar(pattern, routing),
           ref.pattern_kbar(pattern, routing))
    got = PF.alltoall_time(fab, 1e9, 64, pattern=pattern, routing=routing)
    want = RF.alltoall_time(ref, 1e9, 64, pattern=pattern, routing=routing)
    _close(got.bandwidth_s, want.bandwidth_s)
    _close(got.latency_s, want.latency_s)


def test_pattern_report_cache_and_size_limit():
    fab, _ = _fabric_pair("pn", (4,), 2)
    a = fab.pattern_report("tornado", "ugal")
    assert fab.pattern_report("tornado", "ugal") is a
    pat = P.make_pattern("tornado")
    b = fab.pattern_report(pat, "ugal")
    assert b is not a and fab.pattern_report(pat, "ugal") is b
    assert b.theta == a.theta
    with pytest.raises(ValueError, match="unknown routing"):
        fab.pattern_node_bw("uniform", "ecmp")
    big = PF.FabricModel(P.complete_graph(4), kbar=1.0, u=1.0,
                         device="cpu")
    big.PATTERN_MAX_N = 3
    for call in (lambda: big.pattern_report("tornado"),
                 lambda: big.placement_report({}, None),
                 lambda: big.simulate_pattern("tornado")):
        with pytest.raises(ValueError, match="dense"):
            call()


def test_dragonfly_fabric_keeps_canonical_stats():
    fab, ref = _fabric_pair("dragonfly", (3,), 3)
    assert (fab.kbar, fab.u) == P.dragonfly_canonical_stats(3)
    assert fab.pattern_node_bw("uniform") == ref.pattern_node_bw("uniform")


def test_simulate_pattern_matches_reference():
    """FabricModel.simulate_pattern: the simulator at 0.9x the fluid
    theta (the default offered load), against the reference's dense
    numpy step."""
    fab = PF.FabricModel(PF.torus3d_graph(4, 4, 1), device="cpu")
    ref = RF.FabricModel(ref_torus3d_graph(4, 4, 1))
    got = fab.simulate_pattern("tornado", steps=80,
                               config=SimConfig(backend="dense"))
    want = ref.simulate_pattern("tornado", steps=80,
                                config=RefConfig(backend="numpy"))
    _close(got.offered, want.offered)
    _close(got.offered, 0.9 * fab.pattern_report("tornado", "ugal").theta)
    for key in ("theta", "alpha", "latency", "occupancy"):
        _close(getattr(got, key), getattr(want, key))
    assert got.theta / got.offered > 0.99


def test_torus_fabric_reference_point():
    """A 2x bigger torus with the same per-link bandwidth has a lower
    per-node uniform bandwidth (weak scaling of tori)."""
    f1 = PF.FabricModel(PF.torus3d_graph(4, 4, 4), device="cpu")
    f2 = PF.FabricModel(PF.torus3d_graph(8, 4, 4), device="cpu")
    for fab, dims in ((f1, (4, 4, 4)), (f2, (8, 4, 4))):
        ref = RF.FabricModel(ref_torus3d_graph(*dims))
        _close(fab.node_uniform_bw, ref.node_uniform_bw)
    assert f1.node_uniform_bw > 0
    assert f2.node_uniform_bw < f1.node_uniform_bw


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


def _same_plan(rows, ref_rows):
    """Rows in the reference's order, every column equal (the planner
    rounds its numbers)."""
    assert [r["fabric"] for r in rows] == [r["fabric"] for r in ref_rows]
    for row, ref in zip(rows, ref_rows):
        assert row == ref, row["fabric"]


def test_candidate_fabrics_match_reference():
    got = PF.candidate_fabrics(10_000, 64, device="cpu")
    want = RF.candidate_fabrics(10_000, 64)
    assert [c.fabric.name for c in got] == [c.fabric.name for c in want]
    for c, ref in zip(got, want):
        assert (c.terminals, c.radix) == (ref.terminals, ref.radix)
        assert c.dollars_per_node == ref.dollars_per_node
        assert c.watts_per_node == ref.watts_per_node
        _close(c.fabric.kbar, ref.fabric.kbar)
        _close(c.fabric.u, ref.fabric.u)
        prof = PF.StepProfile({"all-reduce": 1e9, "all-to-all": 1e8})
        _close(c.step_comm_seconds(prof),
               ref.step_comm_seconds(RF.StepProfile(prof.bytes_by_kind)))


def test_fabric_planner_prefers_low_kbar_over_u():
    """The paper's core claim, end to end: at ~10k terminals, demi-PN's
    k̄/u beats Slim Fly MMS's, so the planner ranks demi-PN's collective
    time ahead of SF at equal link speed."""
    kinds = {"all-reduce": 1e9, "all-to-all": 1e8}
    rows = PF.plan(PF.StepProfile(kinds), min_terminals=10_000,
                   max_radix=64, device="cpu")
    _same_plan(rows, RF.plan(RF.StepProfile(kinds), min_terminals=10_000,
                             max_radix=64))
    names = [r["fabric"] for r in rows]
    dpn = next(r for r in rows if r["fabric"].startswith("demi-PN"))
    sf = next(r for r in rows if r["fabric"].startswith("SF-MMS"))
    assert dpn["kbar_over_u"] < sf["kbar_over_u"]
    assert names.index(dpn["fabric"]) < names.index(sf["fabric"])
    # and the paper's Table-4 relation: demi-PN cheaper in W/node than SF
    assert dpn["watts_per_node"] <= sf["watts_per_node"] + 1e-6


def test_plan_placement_aware_matches_reference():
    """With a mesh, each placeable candidate is ranked by its placed
    busiest-link step time under ugal."""
    prof = {"all-to-all": 8e9, "all-reduce": 1e9}
    kw = dict(min_terminals=400, max_radix=64, mesh_shape=(8, 32),
              axis_names=("model", "data"))
    rows = PF.plan(PF.StepProfile(prof), device="cpu", **kw)
    _same_plan(rows, RF.plan(RF.StepProfile(prof), **kw))
    placed = [r for r in rows if "placed_comm_ms" in r]
    assert placed and all(r["placement_routing"] == "ugal" for r in placed)
    assert [r["placed_comm_ms"] for r in placed] \
        == sorted(r["placed_comm_ms"] for r in placed)


def test_step_profile_from_dryrun():
    rec = {"collective_bytes_per_device": {"all-reduce": 3.0,
                                           "all-to-all": 1.0,
                                           "total": 4.0}}
    got = PF.StepProfile.from_dryrun(rec)
    assert got.bytes_by_kind == RF.StepProfile.from_dryrun(rec).bytes_by_kind
    assert got.bytes_by_kind == {"all-reduce": 3.0, "all-to-all": 1.0}
    assert PF.StepProfile.from_dryrun({}).bytes_by_kind == {}


# ---------------------------------------------------------------------------
# simulate_placement (tests/test_sim.py::test_simulate_placement)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,ref_backend", [("dense", "numpy"),
                                                 ("fused", "pallas")])
@pytest.mark.parametrize("routing", ["minimal", "ugal_threshold(0)"])
def test_simulate_placement(backend, ref_backend, routing):
    from repro.fabric.placement import Placement as RefPlacement
    g = PF.torus3d_graph(4, 4, 1)
    ref_g = ref_torus3d_graph(4, 4, 1)
    rp = RefPlacement(graph=ref_g, mesh_shape=(4, 4),
                      axis_names=("data", "model"), router_of=np.arange(16))
    p = placement_from_arrays(g, rp.mesh_shape, rp.axis_names, rp.router_of)
    schedule = {"data": ("ring", 64.0), "model": ("all_to_all", 64.0)}
    cfg = SimConfig(backend=backend, dtype="float64")
    ref_cfg = RefConfig(backend=ref_backend, dtype="float64")
    fluid = "minimal" if routing == "minimal" else "ugal"
    th = PF.placement_report(p, schedule, routing=fluid, device="cpu").theta
    _close(th, RF.placement_report(rp, schedule, routing=fluid).theta)
    r = simulate_placement(p, schedule, routing=routing, offered=0.9 * th,
                           steps=160, config=cfg, device="cpu")
    want = ref_simulate_placement(rp, schedule, routing=routing,
                                  offered=0.9 * th, steps=160,
                                  config=ref_cfg)
    over = simulate_placement(p, schedule, routing=routing, steps=160,
                              config=cfg, device="cpu")
    want_over = ref_simulate_placement(rp, schedule, routing=routing,
                                       steps=160, config=ref_cfg)
    for got, ref in ((r, want), (over, want_over)):
        assert (got.steps, got.window, got.backend) == (ref.steps,
                                                        ref.window, backend)
        for key in ("offered", "theta", "alpha", "latency",
                    "delivered_rate", "accepted_rate", "occupancy"):
            _close(getattr(got, key), getattr(ref, key))
    assert r.theta / r.offered > 0.99   # sustains below the analytic knee
    assert r.residual < 1e-12
    assert over.offered == pytest.approx(1.2 * th)
    assert over.theta <= over.offered * (1 + 1e-9)
    with pytest.raises(ValueError, match="router-local"):
        simulate_placement(placement_from_arrays(g, (1, 1), ("data",
                                                             "model"), [0]),
                           schedule, device="cpu")


# The reference's delivered / offered of per-hop ugal_threshold(0) at 0.9x
# the fluid ugal theta of an EP-heavy (benchmarks/placement_bench.py)
# group placement on PN(q), after the simulator's default 144 steps and
# after 432: short of 0.99 and still rising, the same transient that
# the full-width PN(31) job shows on the card.
SETTLING = {
    (7, 3, (8, 16)): {144: 0.9799485559468781, 432: 0.9807532944740639},
    (8, 4, (16, 16)): {144: 0.9530283763402959, 432: 0.9642242145226848},
}


@pytest.mark.parametrize("steps", [144, 432])
@pytest.mark.parametrize("q,delta0,mesh", list(SETTLING))
def test_simulate_placement_settling(q, delta0, mesh, steps):
    """The port's dense and fused float64 runs equal the reference's
    ``numpy`` run at rtol 1e-9, and the reference's reading is the one
    recorded above."""
    from repro.core import pn_graph as ref_pn_graph
    axes = ("model", "data")
    rp = RF.place_mesh(ref_pn_graph(q), mesh, axes, delta0, "group")
    p = placement_from_arrays(P.pn_graph(q), mesh, axes, rp.router_of)
    prof = ref_bench.PROFILES["ep_heavy"]
    th = RF.placement_report(rp, prof, routing="ugal",
                             engine="numpy").theta
    _close(PF.placement_report(p, prof, routing="ugal",
                               device="cpu").theta, th)
    kw = dict(routing="ugal_threshold(0)", offered=0.9 * th, steps=steps)
    want = ref_simulate_placement(
        rp, prof, config=RefConfig(backend="numpy", dtype="float64"), **kw)
    _close(want.theta / want.offered, SETTLING[q, delta0, mesh][steps])
    assert want.theta / want.offered < 0.99
    for backend in ("dense", "fused"):
        got = simulate_placement(
            p, prof, config=SimConfig(backend=backend, dtype="float64"),
            device="cpu", **kw)
        for key in ("offered", "theta", "alpha", "latency",
                    "delivered_rate", "occupancy"):
            _close(getattr(got, key), getattr(want, key))
    if steps > 144:
        short = SETTLING[q, delta0, mesh][144]
        assert want.theta / want.offered > short


# ---------------------------------------------------------------------------
# BENCH_4 (benchmarks/placement_bench.py) on its three small cases
# ---------------------------------------------------------------------------

BENCH4 = {e["name"]: e for e in
          json.loads((ROOT / "BENCH_4.json").read_text())["entries"]}


def _same_bench_rows(rows, want, rtol=1e-9):
    assert [(r["profile"], r["strategy"]) for r in rows] \
        == [(r["profile"], r["strategy"]) for r in want]
    for row, ref in zip(rows, want):
        for key, val in ref.items():
            if key in ("profile", "strategy"):
                continue
            if key in ("theta", "u"):
                # recorded to six digits
                assert row[key] == pytest.approx(val, abs=1e-6), key
            elif val is None:
                assert row[key] is None
            elif key == "alpha":
                assert row[key] == pytest.approx(val, rel=rtol, abs=1e-9)
            else:
                _close(row[key], val, rtol)


@pytest.mark.parametrize("case", [1, 2, 3])
def test_placement_table_matches_reference(case):
    name, g, mesh, axes, delta0, expect = \
        placement_tables.placement_cases()[case]
    ref_name, ref_g, *_ = ref_bench.placement_cases()[case]
    assert name == ref_name
    np.testing.assert_array_equal(g.edges, ref_g.edges)
    rows, summary, err = placement_tables.placement_one(
        g, mesh, axes, delta0, expect, device="cpu")
    ref_rows, ref_summary, ref_err = ref_bench.placement_one(
        ref_g, mesh, axes, delta0, expect)
    _same_bench_rows(rows, ref_rows)
    for key, s in ref_summary.items():
        for field, val in s.items():
            if isinstance(val, float):
                _close(summary[key][field], val)
            else:
                assert summary[key][field] == val, (key, field)
    assert err == pytest.approx(ref_err, abs=1e-12)
    entry = BENCH4[f"placement[{name}]"]
    _same_bench_rows(rows, entry["rows"], rtol=1e-9)
    assert err == pytest.approx(entry["max_rel_err"], abs=1e-12)
    for key, s in entry["summary"].items():
        assert summary[key]["best"] == s["best"]
        if "beats_linear" in s:
            assert summary[key]["beats_linear"] == s["beats_linear"]


def test_placement_table_matches_profiles_and_strategies():
    assert placement_tables.STRATEGIES == ref_bench.STRATEGIES
    assert list(placement_tables.PROFILES) == list(ref_bench.PROFILES)
    for key, prof in ref_bench.PROFILES.items():
        assert placement_tables.PROFILES[key].bytes_by_kind \
            == prof.bytes_by_kind
