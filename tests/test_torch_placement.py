"""repro_torch.fabric.placement against repro.fabric.placement, on the CPU.

Mirrors ``tests/test_placement.py`` and ``tests/test_placement_pipeline.py``
case for case: the chip traffic, the router demand, the schedule's byte
accounting, placement theta, the strategy registry (orbit, greedy), the
search with its adversary, the fragmentation sweep and the parity of the
weighted engines with a per-hop ECMP oracle.  The same inputs (graphs
from the same builders, the same seeds) go through the reference and the
port (``device="cpu"``):

* traffic triples, demands and ``router_of``: equal bit for bit;
* thetas, u, ``kbar_eff`` and loads: rtol 1e-9 against the reference's
  ``numpy`` engine (the port's ``dense`` and ``fused`` engines, and
  ``auto``, which takes the orbit shortcut on uniform-shaped demands);
* greedy histories: step for step within 1e-9 up to the first step whose
  accept decision differs, where the accepting side's candidate must tie
  the incumbent within 1e-9 (``m < best`` on an exact tie turns on one
  rounding); the step is named by ``_same_descent``.  On the cases here
  the two descents take the same decisions throughout.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.fabric as RF
import repro_torch.core as P
import repro_torch.fabric as PF
from repro.core.graph import bfs_distances_batched as ref_bfs_batched
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
from repro.fabric.placement import chip_wire_bytes as ref_chip_wire_bytes
from repro.perf import flags as ref_flags
from repro.perf import set_flags as ref_set_flags
from repro_torch.convert import placement_from_arrays
from repro_torch.core.graph import bfs_distances
from repro_torch.fabric.placement import chip_wire_bytes

MESH = (8, 8)
AXES = ("data", "model")
TRAFFIC = {"data": ("ring", 1.0), "model": ("all_to_all", 1.0)}
ENGINES = ["dense", "fused"]
TIE = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    # torch runs these tiny sizes faster on one thread
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_numpy_engine():
    """The reference's calls that take no engine run its exact ``numpy``
    engine (its ``auto`` reaches the float64 jax path, dead on the
    installed jax)."""
    old = ref_flags().util_engine
    ref_set_flags(util_engine="numpy")
    yield
    ref_set_flags(util_engine=old)


def _profile():
    return (PF.StepProfile({"all-to-all": 8e9, "all-reduce": 1e9}),
            RF.StepProfile({"all-to-all": 8e9, "all-reduce": 1e9}))


def _demi_pn9():
    return P.build_topology("demi_pn", 9), R.build_topology("demi_pn", 9)


BUILDERS = {
    "demi_pn9": _demi_pn9,
    "demi_pn5": lambda: (P.demi_pn_graph(5), R.demi_pn_graph(5)),
    "demi_pn7": lambda: (P.demi_pn_graph(7), R.demi_pn_graph(7)),
    "demi_pn8": lambda: (P.demi_pn_graph(8), R.demi_pn_graph(8)),
    "oft4": lambda: (P.oft_graph(4), R.oft_graph(4)),
    "torus444": lambda: (PF.torus3d_graph(4, 4, 4),
                         ref_torus3d_graph(4, 4, 4)),
    "dragonfly3": lambda: (P.dragonfly_graph(3), R.dragonfly_graph(3)),
    "pn4": lambda: (P.pn_graph(4), R.pn_graph(4)),
    "pn8": lambda: (P.pn_graph(8), R.pn_graph(8)),
    "pn16": lambda: (P.pn_graph(16), R.pn_graph(16)),
}


def _pair(name):
    g, ref = BUILDERS[name]()
    np.testing.assert_array_equal(g.edges, ref.edges)
    return g, ref


def _place(g, ref, *args, **kw):
    """The same placement on both sides, ``router_of`` equal bit for
    bit."""
    p = PF.place_mesh(g, *args, device="cpu", **kw)
    rp = RF.place_mesh(ref, *args, **kw)
    np.testing.assert_array_equal(p.router_of, rp.router_of)
    return p, rp


def _close(got, want, rtol=1e-9):
    assert got == pytest.approx(want, rel=rtol)


def _loads_close(got, want, rtol=1e-9):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(want)))


def _same_report(rep, ref):
    for key in ("pattern", "routing", "diameter", "faults"):
        assert getattr(rep, key) == getattr(ref, key), key
    for key in ("theta", "u", "max_load", "mean_load", "kbar_eff",
                "total_demand"):
        _close(getattr(rep, key), getattr(ref, key))
    assert (rep.alpha is None) == (ref.alpha is None)
    if ref.alpha is not None:
        assert rep.alpha == pytest.approx(ref.alpha, abs=1e-9)
    _loads_close(rep.loads, ref.loads)


def _same_row(row, ref):
    assert set(row) == set(ref)
    for key, want in ref.items():
        if key == "alpha":
            assert (row[key] is None) == (want is None)
            if want is not None:
                assert row[key] == pytest.approx(want, abs=1e-9)
        elif isinstance(want, str):
            assert row[key] == want
        else:
            _close(row[key], want)


def _same_descent(hist, ref_hist):
    """The port's greedy history against the reference's, step for step:
    equal within 1e-9 while both take the same decisions (a swap is
    accepted exactly when the history strictly drops).  At the first
    step whose decision differs, the accepting side's candidate must tie
    the incumbent within 1e-9; returns that step, or None when every
    decision agrees."""
    assert len(hist) == len(ref_hist)
    _close(hist[0], ref_hist[0], TIE)
    for i in range(1, len(ref_hist)):
        took, ref_took = hist[i] < hist[i - 1], ref_hist[i] < ref_hist[i - 1]
        if took != ref_took:
            h = hist if took else ref_hist
            assert h[i] >= h[i - 1] * (1 - TIE), \
                f"step {i}: the descents part on a non-tie"
            return i
        _close(hist[i], ref_hist[i], TIE)
    return None


def _ref_traffic(mesh, axes, spec):
    got = PF.collective_traffic(mesh, axes, spec)
    want = RF.collective_traffic(mesh, axes, spec)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    return got


# ---------------------------------------------------------------------------
# tests/test_placement.py
# ---------------------------------------------------------------------------


def test_traffic_conservation():
    src, dst, byts = _ref_traffic(MESH, AXES, TRAFFIC)
    n = int(np.prod(MESH))
    # ring: every chip sends 2(n-1)/n once; a2a: (n-1) sends of 1/n
    expect = n * (2 * 7 / 8) + n * 7 * (1 / 8)
    assert byts.sum() == pytest.approx(expect)
    assert (src != dst).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_link_loads_route_all_bytes(engine):
    g, ref = _pair("demi_pn9")
    p, rp = _place(g, ref, MESH, AXES, terminals_per_router=1,
                   strategy="linear")
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    r = PF.link_loads(p, traffic, engine=engine, device="cpu")
    want = RF.link_loads(rp, traffic, engine="numpy")
    _loads_close(r["loads"], want["loads"])
    for key in ("max", "mean", "kbar_eff"):
        _close(r[key], want[key])
    # shortest-path routing conserves byte-hops
    src, dst, byts = traffic
    rs, rd = p.router_of[src], p.router_of[dst]
    dist = np.stack([bfs_distances(g, s) for s in range(g.n)])
    expect = float((byts * dist[rs, rd]).sum())
    assert r["loads"].sum() == pytest.approx(expect, rel=1e-9)
    assert r["max"] >= r["mean"] > 0


def test_same_router_traffic_is_free():
    g, ref = _pair("demi_pn9")
    # all chips of a model group on one router -> a2a stays local
    p, rp = _place(g, ref, (1, 8), ("data", "model"),
                   terminals_per_router=8, strategy="linear")
    traffic = _ref_traffic((1, 8), ("data", "model"),
                           {"model": ("all_to_all", 1.0)})
    r = PF.link_loads(p, traffic, device="cpu")
    assert r["max"] == 0.0 == RF.link_loads(rp, traffic)["max"]
    assert len(r["loads"]) == len(g.indices) and not r["loads"].any()


def test_group_placement_beats_linear_for_tp_traffic():
    """Packing each TP group onto few routers (the electrical-group /
    subplane layout) must reduce max link load vs spreading it; a
    transposed mesh makes linear split the groups."""
    g, ref = _pair("demi_pn9")
    traffic = _ref_traffic(MESH, AXES, {"model": ("all_to_all", 1.0)})
    p_bad, rp_bad = _place(g, ref, (8, 8), ("model", "data"), 4, "linear")
    tr_bad = _ref_traffic((8, 8), ("model", "data"),
                          {"model": ("all_to_all", 1.0)})
    p_good, rp_good = _place(g, ref, (8, 8), ("data", "model"), 4, "group")
    m_bad = PF.link_loads(p_bad, tr_bad, device="cpu")["max"]
    m_good = PF.link_loads(p_good, traffic, device="cpu")["max"]
    _close(m_bad, RF.link_loads(rp_bad, tr_bad)["max"])
    _close(m_good, RF.link_loads(rp_good, traffic)["max"])
    assert m_good <= m_bad


def test_greedy_improve_never_worse():
    g, ref = _pair("demi_pn9")
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    p0, rp0 = _place(g, ref, MESH, AXES, 1, "random", seed=3)
    base = PF.link_loads(p0, traffic, device="cpu")["max"]
    placed, improved, hist = PF.greedy_improve(
        p0, traffic, iters=60, seed=4, return_history=True, device="cpu")
    rplaced, _, ref_hist = RF.greedy_improve(rp0, traffic, iters=60, seed=4,
                                             return_history=True)
    if _same_descent(hist, ref_hist) is None:
        np.testing.assert_array_equal(placed.router_of, rplaced.router_of)
    assert improved <= base


def test_evaluate_placements_reports_all_strategies():
    g, ref = _pair("demi_pn9")
    out = PF.evaluate_placements(g, MESH, AXES, 1, TRAFFIC,
                                 routing="minimal", device="cpu")
    want = RF.evaluate_placements(ref, MESH, AXES, 1, TRAFFIC,
                                  routing="minimal", engine="numpy")
    assert list(out) == list(want) == ["linear", "group", "random", "orbit"]
    for name, v in out.items():
        _same_row(v, want[name])
        # theta in Eq. 1 link-equivalents, raw bytes kept for capacity work
        assert v["theta"] > 0
        assert 0 < v["u"] <= 1
        assert v["max_bytes"] >= v["mean_bytes"] >= 0


@settings(max_examples=15, deadline=None)
@given(
    q=st.sampled_from([5, 7, 8]),
    d0=st.integers(1, 4),
    dshape=st.sampled_from([(4, 4), (2, 8), (8, 2)]),
    ring_b=st.floats(0.1, 10.0),
    a2a_b=st.floats(0.0, 10.0),
    strat=st.sampled_from(["linear", "group", "random"]),
)
def test_byte_hop_conservation_property(q, d0, dshape, ring_b, a2a_b, strat):
    """For ANY placement and payload mix, routed arc-bytes equal
    sum(demand x distance), and the port's loads the reference's."""
    g, ref = _pair(f"demi_pn{q}")
    if int(np.prod(dshape)) > g.n * d0:
        return  # job doesn't fit this fabric
    spec = {"data": ("ring", ring_b), "model": ("all_to_all", a2a_b)}
    p, rp = _place(g, ref, dshape, ("data", "model"), d0, strat, seed=1)
    traffic = _ref_traffic(dshape, ("data", "model"), spec)
    src, dst, byts = traffic
    rs, rd = p.router_of[src], p.router_of[dst]
    dist = np.stack([bfs_distances(g, s) for s in range(g.n)])
    r = PF.link_loads(p, traffic, device="cpu")
    assert r["loads"].sum() == pytest.approx(
        float((byts * dist[rs, rd]).sum()), rel=1e-9)
    assert (r["loads"] >= -1e-12).all()
    if r["max"] > 0:
        _loads_close(r["loads"], RF.link_loads(rp, traffic)["loads"])


# ---------------------------------------------------------------------------
# tests/test_placement_pipeline.py: the weighted engines against ECMP
# ---------------------------------------------------------------------------


def _ecmp_link_loads(p, traffic):
    """Per-source BFS with an equal next-hop (ECMP) split: the byte
    accounting the weighted engines replaced in the reference."""
    g = p.graph
    src, dst, byts = traffic
    rs, rd = p.router_of[src], p.router_of[dst]
    key = rs * g.n + rd
    agg = np.zeros(g.n * g.n)
    np.add.at(agg, key, byts)
    dist = ref_bfs_batched(g, np.arange(g.n)).astype(np.int64)
    arc_load = np.zeros(len(g.indices))
    for s in range(g.n):
        demand = agg[s * g.n: (s + 1) * g.n].copy()
        demand[s] = 0.0
        if not demand.any():
            continue
        order = np.argsort(dist[s])
        down = demand.copy()
        for v in order[::-1]:
            if v == s or down[v] <= 0:
                continue
            lo, hi = g.indptr[v], g.indptr[v + 1]
            nbrs = g.indices[lo:hi]
            preds = lo + np.nonzero(dist[s][nbrs] == dist[s][v] - 1)[0]
            if len(preds) == 0:
                continue
            share = down[v] / len(preds)
            for a in preds:
                u = g.indices[a]
                lo_u, hi_u = g.indptr[u], g.indptr[u + 1]
                arc = lo_u + int(np.nonzero(g.indices[lo_u:hi_u] == v)[0][0])
                arc_load[arc] += share
                down[u] += share
    return arc_load


@pytest.mark.parametrize("name", ["demi_pn9", "oft4", "torus444"])
@pytest.mark.parametrize("engine", ENGINES)
def test_link_loads_parity_with_ecmp_oracle(name, engine):
    """On the paper's families and the torus the ECMP per-hop split
    coincides with the equal-path split of the weighted engines arc by
    arc (the oracle runs on the reference's placement and graph)."""
    g, ref = _pair(name)
    p, rp = _place(g, ref, MESH, AXES, 2, "random", seed=5)
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    old = _ecmp_link_loads(rp, traffic)
    new = PF.link_loads(p, traffic, routing="minimal", engine=engine,
                        device="cpu")["loads"]
    np.testing.assert_allclose(new, old, rtol=1e-12, atol=1e-12 * old.max())


@pytest.mark.parametrize("engine", ENGINES)
def test_link_loads_ecmp_delta_documented_on_dragonfly(engine):
    """Dragonfly's unbalanced shortest-path DAGs are where the ECMP
    per-hop split and the equal-path split differ (per arc ~12% at this
    seed) while byte-hops stay identical."""
    g, ref = _pair("dragonfly3")
    p, rp = _place(g, ref, MESH, AXES, 2, "random", seed=5)
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    old = _ecmp_link_loads(rp, traffic)
    new = PF.link_loads(p, traffic, routing="minimal", engine=engine,
                        device="cpu")["loads"]
    _loads_close(new, RF.link_loads(rp, traffic, routing="minimal",
                                    engine="numpy")["loads"])
    assert old.sum() == pytest.approx(new.sum(), rel=1e-12)
    rel = np.abs(old - new).max() / old.max()
    assert 0.05 < rel < 0.2


@pytest.mark.parametrize("engine", ENGINES)
def test_link_loads_routing_registry(engine):
    """Any registered routing model: Valiant's byte-hops exceed
    minimal's (detour), ugal's max load is <= both."""
    g, ref = _pair("demi_pn9")
    p, rp = _place(g, ref, MESH, AXES, 2, "linear")
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    got = {}
    for routing in ("minimal", "valiant", "ugal"):
        got[routing] = PF.link_loads(p, traffic, routing=routing,
                                     engine=engine, device="cpu")
        want = RF.link_loads(rp, traffic, routing=routing, engine="numpy")
        _loads_close(got[routing]["loads"], want["loads"])
        _close(got[routing]["kbar_eff"], want["kbar_eff"])
    assert got["valiant"]["loads"].sum() > got["minimal"]["loads"].sum()
    assert got["ugal"]["max"] <= min(got["minimal"]["max"],
                                     got["valiant"]["max"]) * (1 + 1e-12)


# ---------------------------------------------------------------------------
# placement_demand semantics
# ---------------------------------------------------------------------------


def test_placement_demand_uniform_shape_for_spanning_group():
    """A single model group, one chip per router across the whole fabric,
    compiles to uniform-shaped demand w * (ones - I) — exactly the shape
    the orbit shortcut accepts."""
    g, ref = _pair("pn4")
    p, rp = _place(g, ref, (1, g.n), ("data", "model"), 1, "linear")
    d = PF.placement_demand({"model": ("all_to_all", 3.0)}, p)
    np.testing.assert_array_equal(
        d, RF.placement_demand({"model": ("all_to_all", 3.0)}, rp))
    w = 3.0 / g.n
    expect = w * (np.ones((g.n, g.n)) - np.eye(g.n))
    np.testing.assert_allclose(d, expect, rtol=1e-12)


def test_placement_demand_conserves_off_router_bytes():
    g, ref = _pair("demi_pn9")
    p, rp = _place(g, ref, MESH, AXES, 4, "group", seed=1)
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    d = PF.placement_demand(TRAFFIC, p)
    np.testing.assert_array_equal(d, RF.placement_demand(TRAFFIC, rp))
    src, dst, byts = traffic
    off = p.router_of[src] != p.router_of[dst]
    assert d.sum() == pytest.approx(byts[off].sum(), rel=1e-12)
    assert np.diagonal(d).sum() == 0.0


def test_schedule_from_profile_byte_accounting():
    """StepProfile kinds map onto mesh axes with fabric.collectives' wire
    accounting: an all-gather of b bytes equals an all-reduce of b/2,
    a2a kinds ride the model axis."""
    kinds = {"all-reduce": 4.0, "all-gather": 2.0, "all-to-all": 6.0,
             "collective-permute": 1.0, "reduce-scatter": 0.0}
    sched = PF.schedule_from_profile(PF.StepProfile(kinds),
                                     ("data", "model"))
    assert sched == RF.schedule_from_profile(RF.StepProfile(kinds),
                                             ("data", "model"))
    assert sched["data"] == ("ring", pytest.approx(5.0))   # 4 + 2/2
    assert sched["model"] == ("all_to_all", pytest.approx(7.0))

    with pytest.raises(ValueError, match="unknown collective kind"):
        PF.schedule_from_profile(PF.StepProfile({"broadcast": 1.0}), AXES)
    with pytest.raises(ValueError, match="no 'model' axis"):
        PF.schedule_from_profile(PF.StepProfile({"all-to-all": 1.0}),
                                 ("data", "pod"))
    with pytest.raises(ValueError, match="both ring and all-to-all"):
        PF.schedule_from_profile(PF.StepProfile({"all-to-all": 1.0,
                                                 "all-reduce": 1.0}),
                                 ("data", "model"),
                                 axis_of={"all-to-all": "data"})
    # zero-byte ops drop out entirely
    assert PF.schedule_from_profile(PF.StepProfile({"all-to-all": 0.0}),
                                    ("data",)) == {}


@pytest.mark.parametrize("engine", ENGINES)
def test_placement_theta_scale_invariant(engine):
    """theta is normalized by per-chip wire bytes, so scaling the payload
    leaves it unchanged."""
    g, ref = _pair("demi_pn9")
    p, rp = _place(g, ref, MESH, AXES, 4, "group")
    r1 = PF.placement_report(p, PF.StepProfile({"all-to-all": 1e9}),
                             routing="minimal", engine=engine, device="cpu")
    r7 = PF.placement_report(p, PF.StepProfile({"all-to-all": 7e9}),
                             routing="minimal", engine=engine, device="cpu")
    _same_report(r1, RF.placement_report(
        rp, RF.StepProfile({"all-to-all": 1e9}), routing="minimal",
        engine="numpy"))
    assert r1.theta == pytest.approx(r7.theta, rel=1e-12)
    sched = {"model": ("all_to_all", 8.0)}
    assert chip_wire_bytes(sched, MESH, AXES) \
        == ref_chip_wire_bytes(sched, MESH, AXES) \
        == pytest.approx(8.0 * 7 / 8)


def test_placement_report_all_local_raises():
    g, ref = _pair("demi_pn9")
    p, _ = _place(g, ref, (1, 8), ("data", "model"), 8, "linear")
    with pytest.raises(ValueError, match="router-local"):
        PF.placement_report(p, {"model": ("all_to_all", 1.0)}, device="cpu")


# ---------------------------------------------------------------------------
# End to end through the registry; search beats linear on pn16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_saturation_report_on_placement_demand_ugal(engine):
    g, ref = _pair("pn8")
    prof, ref_prof = _profile()
    p, rp = _place(g, ref, MESH, AXES, 2, "group")
    rep = P.saturation_report(g, PF.placement_demand(prof, p),
                              routing="ugal", engine=engine, device="cpu")
    want = R.saturation_report(ref, RF.placement_demand(ref_prof, rp),
                               routing="ugal", engine="numpy")
    _same_report(rep, want)
    assert rep.theta > 0
    assert rep.routing == "ugal"
    assert rep.alpha is not None


def test_search_beats_linear_on_pn16_nonuniform():
    """Under the routing the fabric runs (ugal), placement search strictly
    beats the naive linear baseline's theta on pn16 for an EP-heavy
    profile (also recorded in BENCH_4.json)."""
    g, ref = _pair("pn16")
    prof, ref_prof = _profile()
    kw = dict(strategies=("linear", "group", "random"), routing="ugal")
    out = PF.placement_search(g, (16, 16), ("model", "data"), 8, prof,
                              device="cpu", **kw)
    want = RF.placement_search(ref, (16, 16), ("model", "data"), 8,
                               ref_prof, engine="numpy", **kw)
    assert out["best"] == want["best"]
    for name, row in want["rows"].items():
        _same_row(out["rows"][name], row)
        np.testing.assert_array_equal(out["placements"][name].router_of,
                                      want["placements"][name].router_of)
    rows = out["rows"]
    assert rows[out["best"]]["theta"] > rows["linear"]["theta"]


def test_placement_search_adversary_scores_occupied_set():
    g, ref = _pair("demi_pn9")
    kw = dict(strategies=("linear", "random"), routing="minimal",
              adversary=True, n_random=2)
    sched = {"model": ("all_to_all", 1.0)}
    out = PF.placement_search(g, (4, 8), AXES, 2, sched, device="cpu", **kw)
    want = RF.placement_search(ref, (4, 8), AXES, 2, sched, engine="numpy",
                               **kw)
    assert out["best"] == want["best"]
    for name, row in out["rows"].items():
        ref_row = want["rows"][name]
        assert row["adv_pattern"] == ref_row["adv_pattern"]
        _same_row(row, ref_row)
        assert 0 < row["adv_theta"] <= row["theta"] * 10  # sane scale
        assert isinstance(row["adv_pattern"], str)


# ---------------------------------------------------------------------------
# Strategy registry: orbit + greedy
# ---------------------------------------------------------------------------


def test_orbit_strategy_fills_leaf_columns_first():
    g, ref = _pair("oft4")  # 63 routers, 42 leaves
    leaf = g.meta["leaf_mask"]
    p, _ = _place(g, ref, (4, 8), AXES, 1, "orbit")
    assert leaf[p.router_of].all()
    # linear ploughs straight through the spine columns
    p_lin, _ = _place(g, ref, (4, 8), AXES, 1, "linear")
    assert not leaf[p_lin.router_of].all()


def test_orbit_placement_hits_orbit_shortcut(monkeypatch):
    """A model group spanning the whole fabric one chip per router gives
    uniform-shaped demand, which the port's weighted engine routes
    through its orbit shortcut under ``auto`` (counted), and the report
    equals the reference's exact sweep."""
    util = importlib.import_module("repro_torch.core.utilization")
    g, ref = _pair("pn4")
    hits = []
    real = util._loads_orbit

    def spy(*a, **kw):
        res = real(*a, **kw)
        hits.append(res is not None)
        return res

    monkeypatch.setattr(util, "_loads_orbit", spy)
    p, rp = _place(g, ref, (1, g.n), ("data", "model"), 1, "orbit")
    sched = {"model": ("all_to_all", 1.0)}
    rep = PF.placement_report(p, sched, routing="minimal", engine="auto",
                              device="cpu")
    assert hits == [True], "spanning-group demand missed the orbit path"
    _same_report(rep, RF.placement_report(rp, sched, routing="minimal",
                                          engine="numpy"))
    assert rep.theta > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_greedy_improve_deterministic_and_monotone(engine):
    g, ref = _pair("demi_pn9")
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    p0, rp0 = _place(g, ref, MESH, AXES, 2, "random", seed=3)
    base = PF.link_loads(p0, traffic, engine=engine, device="cpu")["max"]
    p_a, best_a, hist = PF.greedy_improve(p0, traffic, iters=40, seed=4,
                                          engine=engine,
                                          return_history=True, device="cpu")
    p_b, best_b = PF.greedy_improve(p0, traffic, iters=40, seed=4,
                                    engine=engine, device="cpu")
    # seed-deterministic: identical assignment and objective
    np.testing.assert_array_equal(p_a.router_of, p_b.router_of)
    assert best_a == best_b
    # monotone non-increasing objective, never worse than the start
    assert hist[0] == pytest.approx(base)
    assert all(a >= b for a, b in zip(hist, hist[1:]))
    assert best_a <= base
    rp, ref_best, ref_hist = RF.greedy_improve(rp0, traffic, iters=40,
                                               seed=4, engine="numpy",
                                               return_history=True)
    if _same_descent(hist, ref_hist) is None:
        np.testing.assert_array_equal(p_a.router_of, rp.router_of)
        _close(best_a, ref_best)


def test_greedy_swap_strategy_needs_schedule():
    g, ref = _pair("demi_pn9")
    with pytest.raises(ValueError, match="schedule"):
        PF.place_mesh(g, MESH, AXES, 2, "greedy_swap", device="cpu")
    p = PF.place_mesh(g, MESH, AXES, 2, "greedy_swap(20)", schedule=TRAFFIC,
                      device="cpu")
    rp = RF.place_mesh(ref, MESH, AXES, 2, "greedy_swap(20)",
                       schedule=TRAFFIC)
    lin, _ = _place(g, ref, MESH, AXES, 2, "group")
    traffic = _ref_traffic(MESH, AXES, TRAFFIC)
    # the descent from group under minimal, replayed with its history
    _, _, hist = PF.greedy_improve(lin, traffic, iters=20, seed=0,
                                   return_history=True, device="cpu")
    _, _, ref_hist = RF.greedy_improve(
        RF.place_mesh(ref, MESH, AXES, 2, "group"), traffic, iters=20,
        seed=0, return_history=True)
    if _same_descent(hist, ref_hist) is None:
        np.testing.assert_array_equal(p.router_of, rp.router_of)
    assert PF.link_loads(p, traffic, device="cpu")["max"] \
        <= PF.link_loads(lin, traffic, device="cpu")["max"]


def test_place_mesh_rejects_oversubscription():
    g, _ = _pair("demi_pn9")
    bad = PF.PlacementStrategy(
        "bad", lambda g, mesh, axes, d0, **kw:
        np.zeros(int(np.prod(mesh)), dtype=np.int64))
    with pytest.raises(ValueError, match="oversubscribed"):
        PF.place_mesh(g, MESH, AXES, 2, bad, device="cpu")
    with pytest.raises(ValueError, match="terminals"):
        PF.place_mesh(g, (16, 16), AXES, 2, "linear", device="cpu")


def test_placement_from_arrays_carries_a_reference_placement():
    g, ref = _pair("demi_pn9")
    rp = RF.place_mesh(ref, MESH, AXES, 2, "random", seed=7)
    p = placement_from_arrays(g, rp.mesh_shape, rp.axis_names, rp.router_of)
    assert (p.mesh_shape, p.axis_names) == (rp.mesh_shape, rp.axis_names)
    np.testing.assert_array_equal(p.router_of, rp.router_of)
    np.testing.assert_array_equal(p.occupied, rp.occupied)
    np.testing.assert_array_equal(PF.placement_demand(TRAFFIC, p),
                                  RF.placement_demand(TRAFFIC, rp))
    with pytest.raises(ValueError, match="chips"):
        placement_from_arrays(g, (4, 4), AXES, rp.router_of)
    with pytest.raises(ValueError, match="outside"):
        placement_from_arrays(g, (1, 2), AXES, [0, g.n])


# ---------------------------------------------------------------------------
# Fragmentation: packed vs interleaved vs linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,mesh,delta0", [
    ("pn16", (16, 16), 8),
    ("dragonfly3", (8, 8), 4),
])
def test_packed_dominates_fragmented_under_tornado_ugal(name, mesh, delta0):
    """Two co-tenant EP-heavy jobs: packed strictly dominates both the
    fragmented interleaved and the chip-major linear layout under tornado
    background + ugal routing."""
    g, ref = _pair(name)
    prof, ref_prof = _profile()
    jobs = [(mesh, ("model", "data"), prof)] * 2
    out = PF.fragmentation_sweep(g, jobs, delta0, routing="ugal",
                                 background="tornado", device="cpu")
    want = RF.fragmentation_sweep(ref, [(mesh, ("model", "data"),
                                         ref_prof)] * 2, delta0,
                                  routing="ugal", background="tornado",
                                  engine="numpy")
    assert out["best"] == want["best"] == "packed"
    for layout, row in want["layouts"].items():
        _same_row(out["layouts"][layout], row)
    rows = out["layouts"]
    assert rows["packed"]["theta"] > rows["interleaved"]["theta"]
    assert rows["packed"]["theta"] > rows["linear"]["theta"]


# ---------------------------------------------------------------------------
# Planner wiring
# ---------------------------------------------------------------------------


def test_placement_step_seconds_prices_busiest_link():
    g, ref = _pair("demi_pn9")
    prof, ref_prof = _profile()
    fab = PF.FabricModel(g, terminals_per_router=4, device="cpu")
    ref_fab = RF.FabricModel(ref, terminals_per_router=4)
    _close(fab.kbar, ref_fab.kbar)
    _close(fab.u, ref_fab.u)
    p = fab.place(MESH, AXES, strategy="group")
    rp = ref_fab.place(MESH, AXES, strategy="group")
    np.testing.assert_array_equal(p.router_of, rp.router_of)
    t_group = PF.placement_step_seconds(fab, prof, p, routing="minimal")
    _close(t_group, RF.placement_step_seconds(ref_fab, ref_prof, rp,
                                              routing="minimal",
                                              engine="numpy"))
    d = PF.placement_demand(prof, p)
    loads, _, _ = P.arc_loads_weighted(g, d, device="cpu")
    expect = loads.max() / fab.link_bytes_per_s
    assert t_group == pytest.approx(expect, rel=1e-6, abs=1e-4)
    # all-local placement is free on the fabric
    p_local = fab.place((1, 4), AXES, strategy="linear")
    assert PF.placement_step_seconds(
        fab, {"model": ("all_to_all", 1e9)}, p_local) == 0.0


def test_fabric_model_placement_report_wiring():
    g, ref = _pair("pn8")
    prof, ref_prof = _profile()
    fab = PF.FabricModel(g, terminals_per_router=2, device="cpu")
    ref_fab = RF.FabricModel(ref, terminals_per_router=2)
    p = fab.place(MESH, AXES)
    rp = ref_fab.place(MESH, AXES)
    rep = fab.placement_report(prof, p, routing="ugal")
    _same_report(rep, ref_fab.placement_report(ref_prof, rp, routing="ugal",
                                               engine="numpy"))
    assert rep.routing == "ugal"
    assert rep.theta > 0


def test_adversary_accepts_router_id_lists():
    g, _ = _pair("pn4")
    ids = np.arange(8)
    mask = np.zeros(g.n, dtype=bool)
    mask[ids] = True
    a = P.worst_case(g, "minimal", n_random=2, targets_mask=ids,
                     device="cpu")
    b = P.worst_case(g, "minimal", n_random=2, targets_mask=mask,
                     device="cpu")
    assert a.worst_pattern == b.worst_pattern
    assert a.worst_theta == pytest.approx(b.worst_theta, rel=1e-12)
