"""repro_torch.core.faults against repro.core.faults, on the CPU.

Mirrors ``tests/test_faults.py``: FaultSet identity and resolution, the
degraded-graph compilation, the connectivity report, the seeded and the
targeted constructors, the analytic reroute (``degraded_report``,
``saturation_report(faults=)``) and ``degradation_sweep``.  Fault sets
and degraded graphs must equal the reference's exactly (the same numpy
draws from the same seeds); degraded thetas lie within rtol 1e-9 of the
reference's ``numpy`` engine through both port engines (``dense`` and
``fused``; the sweeps sum in different orders), and the Brandes
conservation identity holds on the surviving topology.  ``worst_case``
on degraded graphs equals the reference's, and a fault set turns the
orbit shortcut off: a degraded graph has no generators, so ``auto``
runs the exact engine and ``orbit`` raises.  The fabric layer's fault
cases, ``placement_report(faults=)`` and the planner's resilience
columns (``plan(resilience_k=)``), are held against the reference the
same way.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core as R
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
import repro_torch.core as P
from repro_torch.convert import fault_set_from_arrays
from repro_torch.core.graph import bfs_distances_batched
from repro_torch.fabric import torus3d_graph

GRAPHS = [
    ("pn5", lambda m: m.pn_graph(5)),
    ("demi_pn4", lambda m: m.demi_pn_graph(4)),
    ("oft3", lambda m: m.oft_graph(3)),
    ("torus_4x4", lambda m: (torus3d_graph if m is P
                             else ref_torus3d_graph)(4, 4, 1)),
    ("hcube4", lambda m: m.hypercube_graph(4)),
]
ENGINES = ["dense", "fused"]


@pytest.fixture(autouse=True)
def _one_thread():
    # torch on this box is slow multithreaded at tiny sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(i):
    _, build = GRAPHS[i]
    return build(P), build(R)


def _port_fs(fs):
    return fault_set_from_arrays(fs.links, fs.routers)


def _same_graph(got, want):
    assert got.n == want.n and got.name == want.name
    np.testing.assert_array_equal(got.edges, want.edges)
    assert set(got.meta) == set(want.meta)
    for key, val in want.meta.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(got.meta[key], val)
        else:
            assert got.meta[key] == val, key


def _active(g):
    leaf = g.meta.get("leaf_mask")
    return None if leaf is None else np.asarray(leaf, dtype=bool)


def _degraded_conservation(g, fs, rep):
    """sum(loads) == sum(D_restricted * dist_degraded): the Brandes
    identity on the surviving topology."""
    gd = fs.apply(g)
    dem = fs.restrict_demand(
        g, P.normalize_demand(P.make_pattern("uniform").demand(g,
                                                               _active(g))))
    np.fill_diagonal(dem, 0.0)
    dist = bfs_distances_batched(gd, np.arange(gd.n),
                                 device="cpu").numpy().astype(np.float64)
    assert rep.loads.sum() == pytest.approx(float((dist * dem).sum()),
                                            rel=1e-8)


def _close(got, want, rtol=1e-9):
    assert got == pytest.approx(want, rel=rtol)


# ---------------------------------------------------------------------------
# FaultSet: canonical identity and graph resolution
# ---------------------------------------------------------------------------


def test_faultset_canonicalization():
    fs = P.FaultSet(links=[(7, 3), (3, 7), (1, 2)], routers=[9, 4, 9])
    assert fs.links == ((1, 2), (3, 7))
    assert fs.routers == (4, 9)
    assert fs == P.FaultSet(links=[(2, 1), (7, 3)], routers=(9, 4))
    assert fs.label == "links[1-2,3-7]+routers[4,9]"
    assert fs.label == R.FaultSet(links=[(7, 3), (1, 2)],
                                  routers=[9, 4]).label
    assert P.FaultSet().empty and P.FaultSet().label == "none"
    assert not fs.empty
    with pytest.raises(ValueError, match="self-loop"):
        P.FaultSet(links=[(3, 3)])


def test_edge_ids_and_router_ids():
    g, ref = P.pn_graph(4), R.pn_graph(4)
    u, v = (int(x) for x in g.edges[0])
    assert P.FaultSet(links=[(u, v)]).edge_ids(g).tolist() == [0]
    adj = {tuple(sorted(map(int, e))) for e in g.edges}
    nonedge = next((a, b) for a in range(g.n) for b in range(a + 1, g.n)
                   if (a, b) not in adj)
    with pytest.raises(ValueError, match="not edges"):
        P.FaultSet(links=[nonedge]).edge_ids(g)
    with pytest.raises(ValueError, match="out of range"):
        P.FaultSet(routers=[g.n]).router_ids(g)
    fs = R.random_faults(ref, k_links=4, k_routers=2, seed=3)
    pfs = _port_fs(fs)
    for method in ("edge_ids", "router_ids", "router_mask", "edge_alive",
                   "survivors"):
        np.testing.assert_array_equal(getattr(pfs, method)(g),
                                      getattr(fs, method)(ref))
    np.testing.assert_array_equal(pfs.restrict_active(g),
                                  fs.restrict_active(ref))


# ---------------------------------------------------------------------------
# apply: degraded-graph compilation
# ---------------------------------------------------------------------------


def test_apply_link_faults_preserves_n_and_family():
    g, ref = torus3d_graph(4, 4, 1), ref_torus3d_graph(4, 4, 1)
    fs = P.random_faults(g, k_links=3, seed=1)
    assert fs == _port_fs(R.random_faults(ref, k_links=3, seed=1))
    gd = fs.apply(g)
    _same_graph(gd, _port_fs(fs).apply(g))
    _same_graph(gd, R.FaultSet(links=fs.links).apply(ref))
    assert gd.n == g.n and gd.num_edges == g.num_edges - 3
    assert gd.meta.get("family") == g.meta.get("family")
    assert gd.meta["faults"] == fs.label
    lost = {tuple(sorted(map(int, e))) for e in g.edges} \
        - {tuple(sorted(map(int, e))) for e in gd.edges}
    assert lost == set(fs.links)


def test_apply_router_faults_relabels_survivors():
    g, ref = P.pn_graph(4), R.pn_graph(4)
    fs = P.FaultSet(routers=[0, 5])
    gd = fs.apply(g)
    _same_graph(gd, R.FaultSet(routers=[0, 5]).apply(ref))
    assert gd.n == g.n - 2
    assert "family" not in gd.meta and gd.meta["faults"] == fs.label
    surv = gd.meta["fault_survivors"]
    assert surv.tolist() == [v for v in range(g.n) if v not in (0, 5)]
    adj = {tuple(sorted(map(int, e))) for e in g.edges}
    for a, b in gd.edges:
        assert tuple(sorted((int(surv[a]), int(surv[b])))) in adj
    with pytest.raises(ValueError, match="empty FaultSet"):
        P.FaultSet().apply(g)


def test_router_faults_restrict_leaf_mask():
    g, ref = P.oft_graph(3), R.oft_graph(3)
    leaf = np.asarray(g.meta["leaf_mask"], dtype=bool)
    dead = int(np.nonzero(~leaf)[0][0])
    gd = P.FaultSet(routers=[dead]).apply(g)
    _same_graph(gd, R.FaultSet(routers=[dead]).apply(ref))
    assert gd.meta["leaf_mask"].sum() == leaf.sum()
    assert gd.meta["leaf_mask"].shape == (g.n - 1,)


def test_fault_report_matches_reference():
    g, ref = torus3d_graph(4, 4, 1), ref_torus3d_graph(4, 4, 1)
    cut = [tuple(sorted(map(int, e))) for e in g.edges
           if 5 in (int(e[0]), int(e[1]))]
    for fs in (P.random_faults(g, k_links=2, seed=3), P.FaultSet(links=cut),
               P.FaultSet(routers=[2, 7]), P.FaultSet()):
        got = P.fault_report(g, fs)
        want = R.fault_report(ref, R.FaultSet(links=fs.links,
                                               routers=fs.routers))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rep = P.fault_report(g, P.FaultSet(links=cut))
    assert not rep.connected and not rep.evaluable
    assert sorted(rep.component_sizes) == [1, g.n - 1]


@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_random_faults_equal_reference(i):
    g, ref = _pair(i)
    for seed in (0, 1, 7):
        for k_links, k_routers in ((1, 0), (3, 0), (2, 1), (0, 2)):
            got = P.random_faults(g, k_links=k_links, k_routers=k_routers,
                                  seed=seed)
            want = R.random_faults(ref, k_links=k_links,
                                   k_routers=k_routers, seed=seed)
            assert (got.links, got.routers) == (want.links, want.routers)
            assert P.fault_report(g, got).evaluable
    assert P.random_faults(g, seed=5).empty
    with pytest.raises(ValueError, match=">= 0"):
        P.random_faults(g, k_links=-1)


# ---------------------------------------------------------------------------
# Analytic reroute: degraded theta semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("routing", ["minimal", "ugal", "valiant"])
@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_degraded_theta_matches_reference(i, routing, engine):
    g, ref = _pair(i)
    for fs in (R.random_faults(ref, k_links=2, seed=0),
               R.random_faults(ref, k_links=1, k_routers=1, seed=4)):
        want = R.degraded_report(ref, "uniform", fs, routing=routing,
                                 engine="numpy")
        got = P.degraded_report(g, "uniform", _port_fs(fs), routing=routing,
                                engine=engine, device="cpu")
        for key in ("theta", "u", "max_load", "mean_load", "kbar_eff",
                    "total_demand"):
            _close(getattr(got, key), getattr(want, key))
        assert got.diameter == want.diameter
        assert got.faults == want.faults == fs.label
        np.testing.assert_allclose(got.loads, want.loads, rtol=1e-9,
                                   atol=1e-12)
    pristine = P.saturation_report(g, "uniform", routing=routing,
                                   engine=engine, device="cpu").theta
    fs = P.random_faults(g, k_links=2, seed=0)
    rep = P.degraded_report(g, "uniform", fs, routing=routing, engine=engine,
                            device="cpu")
    assert rep.theta <= pristine * (1 + 1e-9)
    if routing == "minimal":
        _degraded_conservation(g, fs, rep)


def test_saturation_report_faults_delegates():
    g = P.pn_graph(5)
    fs = P.random_faults(g, k_links=3, seed=2)
    via_kw = P.saturation_report(g, "uniform", routing="minimal", faults=fs,
                                 device="cpu")
    direct = P.degraded_report(g, "uniform", fs, routing="minimal",
                               device="cpu")
    assert via_kw.theta == pytest.approx(direct.theta, rel=1e-12)
    assert via_kw.faults == fs.label
    pristine = P.saturation_report(g, "uniform", routing="minimal",
                                   faults=P.FaultSet(), device="cpu")
    assert pristine.faults is None


def test_degraded_router_faults_drop_demand_rows():
    g = P.pn_graph(5)
    fs = P.FaultSet(routers=[3])
    dem = P.normalize_demand(P.make_pattern("uniform").demand(g, None))
    rep = P.degraded_report(g, "uniform", fs, routing="minimal",
                            device="cpu")
    expect = dem.sum() - dem[3, :].sum() - dem[:, 3].sum()
    assert rep.total_demand == pytest.approx(expect, rel=1e-12)
    with pytest.raises(ValueError, match="fewer than 2"):
        P.degraded_report(P.pn_graph(2), "uniform",
                          P.FaultSet(routers=range(1, 14)), device="cpu")


def test_targeted_cut_at_least_as_damaging_as_random_mean():
    g, ref = torus3d_graph(4, 4, 1), ref_torus3d_graph(4, 4, 1)
    fs = P.targeted_faults(g, k=2, kind="links", device="cpu")
    assert len(fs.links) == 2 and P.fault_report(g, fs).evaluable
    th_t = P.degraded_report(g, "uniform", fs, device="cpu").theta
    th_r = np.mean([P.degraded_report(
        g, "uniform", P.random_faults(g, k_links=2, seed=s),
        device="cpu").theta for s in range(6)])
    assert th_t <= th_r + 1e-12
    # the first round's cut is a busiest link of the pristine torus, all
    # of which are alike: its theta is the reference's
    one = P.targeted_faults(g, k=1, kind="links", device="cpu")
    want = R.targeted_faults(ref, k=1, kind="links")
    _close(P.degraded_report(g, "uniform", one, device="cpu").theta,
           R.degraded_report(ref, "uniform", want).theta)


def _same_worst(got, want):
    """Every candidate's theta within rtol 1e-9 of the reference's and
    the same worst pattern by name; where the reference's smallest
    thetas tie within 1e-9 (tornado and shift(1) on a wounded PN(4)),
    rounding picks among them, so the port's pick must be one of the
    tied ones."""
    assert got.routing == want.routing
    assert list(got.thetas) == list(want.thetas)
    for spec, theta in want.thetas.items():
        _close(got.thetas[spec], theta)
    _close(got.worst_theta, want.worst_theta)
    tied = [spec for spec, theta in want.thetas.items()
            if theta <= want.worst_theta * (1 + 1e-9)]
    assert got.worst_pattern in tied
    if len(tied) == 1:
        assert got.worst_pattern == want.worst_pattern


def test_degraded_graph_disables_orbit_shortcut(monkeypatch):
    g, ref = P.pn_graph(5), R.pn_graph(5)
    assert P.automorphism_generators(g) is not None
    fs = P.random_faults(g, k_links=1, seed=0)
    assert fs == _port_fs(R.random_faults(ref, k_links=1, seed=0))
    gd = fs.apply(g)
    assert P.automorphism_generators(gd) is None
    assert R.automorphism_generators(_port_fs(fs).apply(ref)) is None
    assert P.orbit_info(gd) is None
    with pytest.raises(ValueError, match="no known automorphism"):
        P.arc_loads(gd, engine="orbit", device="cpu")
    # auto and a degraded report fall back to the exact engine, whose
    # sweeps run from every source
    U = importlib.import_module("repro_torch.core.utilization")
    sources = []
    real = U._loads

    def spy(g_, src, targets_mask, demand, engine, device):
        sources.append(len(src))
        return real(g_, src, targets_mask, demand, engine, device)

    monkeypatch.setattr(U, "_loads", spy)
    got = P.arc_loads(gd, device="cpu")
    assert sources == [gd.n]
    want = R.arc_loads(_port_fs(fs).apply(ref), engine="numpy")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-12)
    assert got[1:] == want[1:]
    sources.clear()
    rep = P.degraded_report(g, "uniform", fs, device="cpu")
    assert sources == [gd.n]
    _close(rep.theta, R.degraded_report(ref, "uniform", _port_fs(fs)).theta)


@pytest.mark.parametrize("engine", ENGINES + ["auto"])
def test_worst_case_on_degraded_graph(engine):
    g, ref = torus3d_graph(4, 4, 1), ref_torus3d_graph(4, 4, 1)
    fs = P.random_faults(g, k_links=2, seed=0)
    pristine = P.worst_case(g, model="minimal", n_random=2, engine=engine,
                            device="cpu")
    degraded = P.worst_case(g, model="minimal", n_random=2, faults=fs,
                            engine=engine, device="cpu")
    assert degraded.worst_theta <= pristine.worst_theta + 1e-12
    want = R.worst_case(ref, model="minimal", n_random=2,
                        faults=_port_fs(fs), engine="numpy")
    _same_worst(degraded, want)


def test_worst_case_faulted_pn_skips_orbit_path(monkeypatch):
    """A fault set on PN, whose pristine graph takes the shortcut: the
    degraded candidates never reach it, and the thetas are the
    reference's under ugal."""
    g, ref = P.pn_graph(4), R.pn_graph(4)
    fs = P.random_faults(g, k_links=2, seed=0)
    U = importlib.import_module("repro_torch.core.utilization")
    hits = []
    real = U._loads_orbit

    def spy(g_, targets_mask, engine, device):
        res = real(g_, targets_mask, engine, device)
        hits.append(res is not None)
        return res

    monkeypatch.setattr(U, "_loads_orbit", spy)
    got = P.worst_case(g, "ugal", n_random=2, faults=fs, device="cpu")
    assert not any(hits)
    want = R.worst_case(ref, "ugal", n_random=2, faults=_port_fs(fs),
                        engine="numpy")
    _same_worst(got, want)


def test_targeted_router_cut():
    g = P.pn_graph(5)
    fs = P.targeted_faults(g, k=1, kind="routers", device="cpu")
    assert len(fs.routers) == 1
    assert P.degraded_report(g, "uniform", fs, device="cpu").theta \
        <= P.saturation_report(g, "uniform", device="cpu").theta + 1e-12
    with pytest.raises(ValueError, match="unknown fault kind"):
        P.targeted_faults(g, k=1, kind="switches", device="cpu")


# ---------------------------------------------------------------------------
# degradation_sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing", ["minimal", "ugal"])
def test_degradation_sweep_matches_reference(routing):
    g, ref = P.pn_graph(5), R.pn_graph(5)
    kw = dict(k_failures=(0, 1, 3), trials=4, seed=0, routing=routing)
    sw = P.degradation_sweep(g, device="cpu", **kw)
    want = R.degradation_sweep(ref, engine="numpy", **kw)
    assert sw.thetas.shape == (4, 3) and sw.k_failures == want.k_failures
    np.testing.assert_allclose(sw.thetas, want.thetas, rtol=1e-9)
    for key in ("mean", "worst", "best"):
        np.testing.assert_allclose(getattr(sw, key), getattr(want, key),
                                   rtol=1e-9)
    for p in (10, 50, 90):
        np.testing.assert_allclose(sw.bands[p], want.bands[p], rtol=1e-9)
    _close(sw.pristine_theta, want.pristine_theta)
    assert np.allclose(sw.thetas[:, 0], sw.pristine_theta)
    assert (np.diff(sw.thetas, axis=1) <= 1e-12).all()
    assert (np.diff(sw.mean) <= 1e-12).all()
    assert (sw.worst <= sw.mean + 1e-12).all()
    assert (sw.mean <= sw.best + 1e-12).all()
    assert set(sw.bands) == {10, 50, 90}
    sw2 = P.degradation_sweep(g, device="cpu", **kw)
    np.testing.assert_array_equal(sw.thetas, sw2.thetas)


def test_degradation_sweep_router_kind():
    g, ref = P.demi_pn_graph(4), R.demi_pn_graph(4)
    kw = dict(k_failures=(0, 1, 2), trials=3, kind="routers", seed=1)
    sw = P.degradation_sweep(g, device="cpu", **kw)
    want = R.degradation_sweep(ref, engine="numpy", **kw)
    np.testing.assert_allclose(sw.thetas, want.thetas, rtol=1e-9)
    assert (np.diff(sw.thetas, axis=1) <= 1e-12).all()
    with pytest.raises(ValueError, match="unknown fault kind"):
        P.degradation_sweep(g, kind="switches", device="cpu")


def test_degradation_sweep_indirect_network():
    """OFT: only leaves inject and receive; the sweep keeps the leaf mask
    through every degraded graph."""
    g, ref = P.oft_graph(3), R.oft_graph(3)
    kw = dict(k_failures=(0, 1, 2), trials=2, seed=2)
    sw = P.degradation_sweep(g, device="cpu", **kw)
    want = R.degradation_sweep(ref, engine="numpy", **kw)
    np.testing.assert_allclose(sw.thetas, want.thetas, rtol=1e-9)



# ---------------------------------------------------------------------------
# The fabric layer under faults: placement theta and the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_placement_report_faults(engine):
    import repro.fabric as RF
    import repro_torch.fabric as PF
    g, ref = P.demi_pn_graph(9), R.demi_pn_graph(9)
    p = PF.place_mesh(g, (8, 8), ("data", "model"), 4, "group",
                      device="cpu")
    rp = RF.place_mesh(ref, (8, 8), ("data", "model"), 4, "group")
    np.testing.assert_array_equal(p.router_of, rp.router_of)
    kinds = {"all-to-all": 8e9, "all-reduce": 1e9}
    prof, ref_prof = PF.StepProfile(kinds), RF.StepProfile(kinds)
    pristine = PF.placement_report(p, prof, routing="minimal",
                                   engine=engine, device="cpu")
    ref_fs = R.random_faults(ref, k_links=2, seed=0)
    fs = P.random_faults(g, k_links=2, seed=0)
    assert fs == _port_fs(ref_fs)
    degraded = PF.placement_report(p, prof, routing="minimal", faults=fs,
                                   engine=engine, device="cpu")
    assert degraded.faults == fs.label and pristine.faults is None
    assert degraded.theta <= pristine.theta * (1 + 1e-9)
    # a dead occupied router takes its chips' demand with it
    dead = _port_fs(R.FaultSet(routers=[int(rp.router_of[0])]))
    for port_fs, want_fs in ((None, None), (fs, ref_fs),
                             (dead, R.FaultSet(routers=dead.routers))):
        for routing in ("minimal", "ugal"):
            got = PF.placement_report(p, prof, routing=routing,
                                      faults=port_fs, engine=engine,
                                      device="cpu")
            want = RF.placement_report(rp, ref_prof, routing=routing,
                                       faults=want_fs, engine="numpy")
            assert (got.faults, got.diameter) == (want.faults,
                                                  want.diameter)
            for key in ("theta", "u", "kbar_eff", "total_demand"):
                _close(getattr(got, key), getattr(want, key))
            np.testing.assert_allclose(got.loads, want.loads, rtol=1e-9,
                                       atol=1e-9 * want.loads.max())


def test_planner_resilience_columns():
    import repro.fabric as RF
    import repro_torch.fabric as PF
    from repro.perf import flags, set_flags
    kinds = {"all-reduce": 1e9, "all-to-all": 1e8}
    rows = PF.plan(PF.StepProfile(kinds), min_terminals=100, resilience_k=1,
                   resilience_trials=2, device="cpu")
    old = flags().util_engine
    set_flags(util_engine="numpy")  # the reference's plan takes no engine
    try:
        want = RF.plan(RF.StepProfile(kinds), min_terminals=100,
                       resilience_k=1, resilience_trials=2)
    finally:
        set_flags(util_engine=old)
    assert [r["fabric"] for r in rows] == [r["fabric"] for r in want]
    for row, ref_row in zip(rows, want):
        assert row == ref_row, row["fabric"]
    small = [r for r in rows if "resilience_theta" in r]
    assert small, "no candidate got resilience columns"
    for r in small:
        assert r["resilience_k"] == 1
        assert 0 < r["resilience_frac"] <= 1.0 + 1e-9
        assert r["resilience_theta"] > 0
    # the columns before the planner's rounding, at rtol 1e-9
    for cand in PF.candidate_fabrics(100, 64, device="cpu"):
        if cand.fabric.graph.n > PF.planner.PLACEMENT_MAX_N:
            continue
        kw = dict(k_failures=(1,), trials=2, pattern="uniform",
                  routing="ugal", kind="links", seed=0)
        sw = P.degradation_sweep(cand.fabric.graph, device="cpu", **kw)
        ref_sw = R.degradation_sweep(_ref_graph(cand.fabric.graph),
                                     engine="numpy", **kw)
        _close(float(sw.worst[0]), float(ref_sw.worst[0]))
        _close(sw.pristine_theta, ref_sw.pristine_theta)


def _ref_graph(g):
    return R.Graph(g.n, g.edges, name=g.name, meta=dict(g.meta))

# ---------------------------------------------------------------------------
# Property: degraded theta <= pristine and conservation, random fault sets
# (hypothesis and a deterministic seeded twin)
# ---------------------------------------------------------------------------


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(gi=st.integers(0, len(GRAPHS) - 1), seed=st.integers(0, 2 ** 16),
       k=st.integers(1, 3))
def test_property_degraded_theta_and_conservation(gi, seed, k):
    g, _ = _pair(gi)
    fs = P.random_faults(g, k_links=k, seed=seed)
    rep = P.degraded_report(g, "uniform", fs, routing="minimal",
                            device="cpu")
    assert rep.theta <= P.saturation_report(
        g, "uniform", device="cpu").theta * (1 + 1e-9)
    _degraded_conservation(g, fs, rep)


def test_property_degraded_theta_deterministic_twin():
    for gi in range(len(GRAPHS)):
        g, _ = _pair(gi)
        pristine = P.saturation_report(g, "uniform", device="cpu").theta
        for seed, k in [(0, 1), (1, 2), (2, 3)]:
            fs = P.random_faults(g, k_links=k, seed=seed)
            rep = P.degraded_report(g, "uniform", fs, routing="minimal",
                                    device="cpu")
            assert rep.theta <= pristine * (1 + 1e-9)
            _degraded_conservation(g, fs, rep)
