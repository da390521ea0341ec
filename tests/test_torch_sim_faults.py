"""repro_torch.sim's fault model against repro.sim's, on the CPU in
float64.

Mirrors ``tests/test_sim_faults.py``: masked route tables, the event
schedule, the state surgery, and the run-level seams (static masked ==
removed graph exactly; a mid-run fault dips and heals; a router fault
drops fluid, counts it and conserves; static and mid-run knees agree).
Each is held against the reference as well:

* faulted tables element for element: the masks exactly, the splits,
  spreads and hop estimates within 1e-12 (they are equal);
* surgery on the same state against the reference's surgery, dropped
  mass at rtol 1e-12;
* runs with fault events through the dense step against the reference's
  ``backend="numpy"`` and through the fused step against its
  ``backend="pallas", dtype="float64"`` (never its jax paths, whose
  float64 mode is dead on the installed jax), histories at rtol 1e-9
  (atol 1e-12), the tolerance of ``tests/test_torch_sim.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.traffic import make_pattern as ref_make_pattern
from repro.core.traffic import normalize_demand
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
from repro.sim import SimConfig as RefConfig
from repro.sim import Simulator as RefSimulator
from repro.sim.faults import apply_fault_surgery as ref_surgery
from repro.sim.tables import build_tables as ref_build_tables
import repro_torch.core as P
from repro_torch.convert import (fault_set_from_arrays, state_from_numpy,
                                 state_to_numpy, tables_from_numpy)
from repro_torch.fabric import torus3d_graph
from repro_torch.sim import (FaultEvent, SimConfig, Simulator,
                             saturation_sweep, simulate)
from repro_torch.sim.faults import apply_fault_surgery, normalize_events
from repro_torch.sim.tables import build_tables

KEYS = ("delivered", "accepted", "offered", "occupancy", "src_backlog",
        "diverted")
MASKS = ("active", "head", "deliver", "slot_ok", "router_ok", "dest_ok",
         "routable")
VALUES = ("split", "spread", "dist_act", "hval_rem")

G16_REF = ref_torus3d_graph(4, 4, 1)
G16 = torus3d_graph(4, 4, 1)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniform(g):
    return normalize_demand(ref_make_pattern("uniform").demand(g, None))


def _pfs(fs):
    return fault_set_from_arrays(fs.links, fs.routers)


def _state_mass(st):
    """Conserved fluid mass of a state tuple: queues + source backlog +
    stage2 credit (``pend`` mirrors vc1 + stage2)."""
    q0, q1, q2, src, pend, stage2 = st
    return float(q0.sum() + q1.sum() + q2.sum() + src.sum() + stage2.sum())


def _tables_equal(have, want):
    assert have.faulted == want.faulted
    assert (have.n, have.k, have.m) == (want.n, want.k, want.m)
    for key in MASKS:
        np.testing.assert_array_equal(getattr(have, key).numpy(),
                                      getattr(want, key), err_msg=key)
    for key in VALUES:
        np.testing.assert_allclose(getattr(have, key).numpy(),
                                   getattr(want, key), rtol=1e-12,
                                   atol=1e-12, err_msg=key)


def _histories_close(port, ref, rtol=1e-9, atol=1e-12):
    for key in KEYS:
        np.testing.assert_allclose(port.history[key], ref.history[key],
                                   rtol=rtol, atol=atol,
                                   err_msg=f"history[{key!r}]")
    np.testing.assert_array_equal(port.history["fault_events"],
                                  ref.history["fault_events"])


# ---------------------------------------------------------------------------
# Masked tables
# ---------------------------------------------------------------------------


def test_pristine_tables_are_all_alive():
    t = build_tables(G16, np.arange(G16.n), device="cpu")
    assert not t.faulted
    assert bool(t.slot_ok.all() and t.router_ok.all() and t.dest_ok.all())
    assert bool(t.routable.all())


TABLE_CASES = {
    "torus_links": (lambda m: (torus3d_graph if m is P
                               else ref_torus3d_graph)(4, 4, 1),
                    lambda g: R.random_faults(g, k_links=3, seed=0)),
    "torus_router": (lambda m: (torus3d_graph if m is P
                                else ref_torus3d_graph)(4, 4, 1),
                     lambda g: R.FaultSet(routers=[5])),
    "demi_pn4_mixed": (lambda m: m.demi_pn_graph(4),
                       lambda g: R.random_faults(g, k_links=2, k_routers=1,
                                                 seed=3)),
    "oft3_spine": (lambda m: m.oft_graph(3),
                   lambda g: R.FaultSet(routers=[13])),
    "oft3_links": (lambda m: m.oft_graph(3),
                   lambda g: R.random_faults(g, k_links=4, seed=1)),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_faulted_tables_match_reference(case):
    build, faults = TABLE_CASES[case]
    g, ref = build(P), build(R)
    fs = faults(ref)
    leaf = ref.meta.get("leaf_mask")
    active = np.arange(ref.n) if leaf is None else np.nonzero(leaf)[0]
    want = ref_build_tables(ref, active, faults=fs)
    have = build_tables(g, active, faults=_pfs(fs), device="cpu")
    _tables_equal(have, want)
    # carried across from the reference's arrays: the same tables
    fields = {f: getattr(want, f) for f in
              ("n", "k", "m", "faulted") + MASKS + VALUES}
    conv = tables_from_numpy(device="cpu", **fields)
    _tables_equal(conv, want)


def test_faulted_tables_masks_and_splits():
    fs = P.random_faults(G16, k_links=3, seed=0)
    t = build_tables(G16, np.arange(G16.n), faults=fs, device="cpu")
    assert t.faulted
    alive = fs.edge_alive(G16)
    slot_ok = t.slot_ok.numpy()
    split = t.split.numpy()
    for r in range(G16.n):
        deg = G16.indptr[r + 1] - G16.indptr[r]
        arcs = np.arange(G16.indptr[r], G16.indptr[r + 1])
        np.testing.assert_array_equal(slot_ok[r, :deg],
                                      alive[G16.arc_edge_id[arcs]])
        assert not slot_ok[r, deg:].any()
    assert bool(t.routable.all())
    for r in range(G16.n):
        for d in range(t.m):
            row = split[r, :, d]
            assert not row[~slot_ok[r]].any()
            if r != int(t.active[d]):
                assert row.sum() == pytest.approx(1.0, abs=1e-12)
    gd = fs.apply(G16)
    np.testing.assert_array_equal(
        t.dist_act.numpy(),
        P.bfs_distances_batched(gd, np.arange(gd.n), device="cpu").numpy())


def test_router_fault_tables_mask_dest_and_row():
    fs = P.FaultSet(routers=[5])
    t = build_tables(G16, np.arange(G16.n), faults=fs, device="cpu")
    assert not bool(t.router_ok[5]) and not bool(t.dest_ok[5])
    assert not bool(t.routable[5, :].any())
    assert not bool(t.routable[:, 5].any())
    assert not bool(t.slot_ok[5].any())
    alive = [r for r in range(G16.n) if r != 5]
    assert bool(t.routable[alive][:, alive].all())
    assert not bool(t.split[:, :, 5].any())
    assert float(t.dist_act[:, 5].abs().sum()) == 0.0


def test_faulted_tables_raise_where_the_reference_does():
    cut = [tuple(sorted(map(int, e))) for e in G16.edges
           if 5 in (int(e[0]), int(e[1]))]
    with pytest.raises(ValueError, match="disconnect the active set"):
        build_tables(G16, np.arange(G16.n), faults=P.FaultSet(links=cut),
                     device="cpu")
    g = P.oft_graph(2)
    leaves = np.nonzero(g.meta["leaf_mask"])[0]
    with pytest.raises(ValueError, match="fewer than 2 active"):
        build_tables(g, leaves[:3], faults=P.FaultSet(routers=leaves[:2]),
                     device="cpu")


# ---------------------------------------------------------------------------
# Event schedule validation
# ---------------------------------------------------------------------------


def test_normalize_events():
    fs = P.random_faults(G16, k_links=1, seed=0)
    evs = normalize_events([(40, P.FaultSet()), FaultEvent(10, fs)])
    assert [e.step for e in evs] == [10, 40]
    assert evs[0].faults == fs and evs[1].faults.empty
    assert normalize_events(None) == ()
    with pytest.raises(ValueError, match="duplicate"):
        normalize_events([(10, fs), (10, P.FaultSet())])
    with pytest.raises(ValueError, match="nonnegative"):
        FaultEvent(-1, fs)
    with pytest.raises(TypeError, match="FaultSet"):
        FaultEvent(3, "links[0-1]")


def test_event_past_run_end_raises():
    sim = Simulator(G16, SimConfig(routing="minimal"), device="cpu")
    fs = P.random_faults(G16, k_links=1, seed=0)
    with pytest.raises(ValueError, match="past"):
        sim.run(_uniform(G16_REF), offered=0.1, steps=50, events=[(50, fs)])


# ---------------------------------------------------------------------------
# State surgery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("links,routers", [((), (5,)),
                                           ("random", ())])
def test_surgery_accounts_every_dropped_unit(links, routers):
    ref_fs = (R.random_faults(G16_REF, k_links=3, seed=2)
              if links == "random" else R.FaultSet(routers=routers))
    fs = _pfs(ref_fs)
    dem = _uniform(G16_REF)
    sim = Simulator(G16, SimConfig(routing="ugal_threshold(0)",
                                   dtype="float64"), device="cpu")
    sim.run(dem, offered=0.3, steps=40)
    st = sim.last_state.as_tuple()
    tb, _ = sim._tables_for(fs)
    st2, dropped = apply_fault_surgery(st, tb)
    assert _state_mass(st2) == pytest.approx(_state_mass(st) - dropped,
                                             rel=1e-12, abs=1e-12)
    if fs.routers:
        assert dropped > 0
    st3, dropped2 = apply_fault_surgery(st2, tb)
    assert dropped2 == pytest.approx(0.0, abs=1e-12)
    for a, b in zip(st2, st3):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    # the reference's surgery on the same state and its own tables
    want_tb = ref_build_tables(G16_REF, np.arange(G16.n), faults=ref_fs)
    want, want_dropped = ref_surgery(state_to_numpy(st), want_tb)
    assert dropped == pytest.approx(want_dropped, rel=1e-12, abs=1e-15)
    for a, b in zip(state_to_numpy(st2), want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_surgery_on_compacted_columns_matches_reference():
    """The fused step's compacted dest axis: q0 / q2 / src and pend's dest
    axis on 6 demanded columns, q1 / stage2 on all 16 mids."""
    rng = np.random.default_rng(0)
    cols = np.sort(rng.choice(16, size=6, replace=False))
    shapes = [(16, 4, 6), (16, 4, 16), (16, 4, 6), (16, 6), (16, 6), (16,)]
    state = [rng.random(s) for s in shapes]
    ref_fs = R.random_faults(G16_REF, k_links=2, k_routers=1, seed=5)
    want_tb = ref_build_tables(G16_REF, np.arange(16), faults=ref_fs)
    want, want_dropped = ref_surgery(state, want_tb, dest_cols=cols)
    tb = build_tables(G16, np.arange(16), faults=_pfs(ref_fs), device="cpu")
    got, dropped = apply_fault_surgery(
        state_from_numpy(state, device="cpu").as_tuple(), tb, dest_cols=cols)
    assert dropped == pytest.approx(want_dropped, rel=1e-12)
    for a, b in zip(state_to_numpy(got), want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_surgery_requeues_dead_slot_fluid():
    fs = P.random_faults(G16, k_links=3, seed=2)
    sim = Simulator(G16, SimConfig(routing="minimal"), device="cpu")
    sim.run(_uniform(G16_REF), offered=0.3, steps=40)
    st = sim.last_state.as_tuple()
    tb, _ = sim._tables_for(fs)
    st2, dropped = apply_fault_surgery(st, tb)
    assert dropped == pytest.approx(0.0, abs=1e-12)
    q0 = st2[0]
    assert not bool((q0 * ~tb.slot_ok[:, :, None]).any())
    np.testing.assert_allclose(float(q0.sum()), float(st[0].sum()),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# Run-level semantics
# ---------------------------------------------------------------------------


def test_static_masked_equals_removed_graph_exactly():
    fs = P.random_faults(G16, k_links=3, seed=1)
    dem = _uniform(G16_REF)
    cfg = SimConfig(routing="ugal_threshold(1)")
    masked = Simulator(G16, cfg, device="cpu").run(
        dem, offered=0.3, steps=120, events=[(0, fs)])
    removed = Simulator(fs.apply(G16), cfg, device="cpu").run(
        dem, offered=0.3, steps=120)
    assert masked.theta == pytest.approx(removed.theta, rel=1e-12)
    for key in ("delivered", "accepted", "occupancy", "diverted"):
        np.testing.assert_allclose(masked.history[key],
                                   removed.history[key], atol=1e-12)
    assert masked.faults == fs.label


@pytest.mark.parametrize("backend,ref_backend", [("dense", "numpy"),
                                                 ("fused", "pallas")])
def test_midrun_fault_dip_and_recovery(backend, ref_backend):
    ref_fs = R.random_faults(G16_REF, k_links=3, seed=1)
    fs = _pfs(ref_fs)
    dem = _uniform(G16_REF)
    ref_theta = R.degraded_report(G16_REF, "uniform", ref_fs).theta
    kw = dict(offered=0.7 * ref_theta, steps=240, window=60)
    sim = Simulator(G16, SimConfig(routing="minimal", backend=backend,
                                   dtype="float64"), device="cpu")
    run = sim.run(dem, events=[(80, fs), (160, P.FaultSet())], **kw)
    d = run.history["delivered"]
    pre = d[60:80].mean()
    assert d[80:95].min() < pre - 1e-6
    assert d[-30:].mean() == pytest.approx(pre, rel=0.02)
    assert run.residual < 1e-9
    assert run.faults is None
    np.testing.assert_array_equal(run.history["fault_events"], [80, 160])
    ref = RefSimulator(G16_REF, RefConfig(routing="minimal",
                                          backend=ref_backend,
                                          dtype="float64")).run(
        dem, events=[(80, ref_fs), (160, R.FaultSet())], **kw)
    _histories_close(run, ref)


@pytest.mark.parametrize("backend,ref_backend", [("dense", "numpy"),
                                                 ("fused", "pallas")])
def test_midrun_router_fault_drops_and_conserves(backend, ref_backend):
    ref_fs = R.FaultSet(routers=[5])
    fs = _pfs(ref_fs)
    dem = _uniform(G16_REF)
    kw = dict(offered=0.3, steps=200, window=50)
    sim = Simulator(G16, SimConfig(routing="ugal_threshold(0)",
                                   backend=backend, dtype="float64"),
                    device="cpu")
    run = sim.run(dem, events=[(70, fs)], **kw)
    assert run.dropped > 0
    assert run.residual < 1e-9
    assert run.faults == fs.label
    degraded = P.degraded_report(G16, "uniform", fs, device="cpu").theta
    assert run.theta / run.offered == pytest.approx(1.0, abs=0.02) \
        or run.theta <= degraded
    ref = RefSimulator(G16_REF, RefConfig(routing="ugal_threshold(0)",
                                          backend=ref_backend,
                                          dtype="float64")).run(
        dem, events=[(70, ref_fs)], **kw)
    _histories_close(run, ref)
    assert run.dropped == pytest.approx(ref.dropped, rel=1e-9)
    # the final state's live links only
    assert run.link_util.shape == (int(sim._tables_for(fs)[0].slot_ok.sum()),)
    assert 0.0 < run.link_util.max() <= 1.0


@pytest.mark.parametrize("backend,ref_backend", [("dense", "numpy"),
                                                 ("fused", "pallas")])
@pytest.mark.parametrize("routing", ["valiant", "ugal_threshold(0)"])
def test_diverting_runs_through_faults_match_reference(routing, backend,
                                                       ref_backend):
    """Past the knee, so that fluid diverts and the pending pool and vc1
    carry it through a link event, a router event and a recovery: the
    faulted pend update (``spread.T @ div_eff``) and the surgery of
    the pool."""
    ref_fs = R.random_faults(G16_REF, k_links=2, seed=4)
    ref_rt = R.FaultSet(links=ref_fs.links, routers=(9,))
    dem = _uniform(G16_REF)
    evs = [(12, ref_fs), (30, ref_rt), (48, R.FaultSet())]
    kw = dict(offered=2.2, steps=64)
    ref = RefSimulator(G16_REF, RefConfig(routing=routing,
                                          backend=ref_backend,
                                          dtype="float64", buffer=6.0)).run(
        dem, events=evs, **kw)
    sim = Simulator(G16, SimConfig(routing=routing, backend=backend,
                                   dtype="float64", buffer=6.0),
                    device="cpu")
    run = sim.run(dem, events=[(s, _pfs(f)) for s, f in evs], **kw)
    assert run.history["diverted"].sum() > 0 and run.dropped > 0
    _histories_close(run, ref)
    assert run.dropped == pytest.approx(ref.dropped, rel=1e-9)
    assert run.residual < 1e-9


def test_fused_compacted_faults_match_reference():
    """The fused step on a compacted dest axis (12 neighbour-fed columns
    of PN(5)'s 62) under ugal with a router fault that kills one of the
    demanded destinations: the columns stay, their fluid is dropped."""
    g_ref = R.pn_graph(5)
    rng = np.random.default_rng(1)
    cols = np.sort(rng.choice(g_ref.n, size=12, replace=False))
    dem = np.zeros((g_ref.n, g_ref.n))
    for c in cols:
        dem[g_ref.neighbors(c), c] = 1.0
    dem = normalize_demand(dem)
    dead = int(cols[3])
    ref_fs = R.FaultSet(routers=(dead,), links=R.random_faults(
        g_ref, k_links=2, seed=0).links)
    kw = dict(offered=6.0, steps=40)
    ref = RefSimulator(g_ref, RefConfig(routing="ugal_threshold(0)",
                                        backend="pallas", dtype="float64",
                                        buffer=4.0), demand=dem).run(
        dem, events=[(15, ref_fs)], **kw)
    sim = Simulator(P.pn_graph(5), SimConfig(routing="ugal_threshold(0)",
                                             backend="fused",
                                             dtype="float64", buffer=4.0),
                    demand=dem, device="cpu")
    np.testing.assert_array_equal(sim.dest_cols, cols)
    run = sim.run(dem, events=[(15, _pfs(ref_fs))], **kw)
    assert run.dropped > 0 and run.history["diverted"].sum() > 0
    _histories_close(run, ref)
    assert run.dropped == pytest.approx(ref.dropped, rel=1e-9)


def test_indirect_network_faults_match_reference():
    """OFT: only leaves inject and receive; a spine router and two links
    die mid-run."""
    g_ref, g = R.oft_graph(3), P.oft_graph(3)
    dem = normalize_demand(ref_make_pattern("uniform").demand(g_ref, None))
    ref_fs = R.FaultSet(routers=(15,), links=R.random_faults(
        g_ref, k_links=2, seed=2).links)
    kw = dict(offered=1.5, steps=48)
    for backend, ref_backend in (("dense", "numpy"), ("fused", "pallas")):
        ref = RefSimulator(g_ref, RefConfig(routing="ugal_threshold(0)",
                                            backend=ref_backend,
                                            dtype="float64"),
                           demand=dem).run(dem, events=[(20, ref_fs)], **kw)
        run = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                     backend=backend, dtype="float64"),
                        demand=dem, device="cpu").run(
            dem, events=[(20, _pfs(ref_fs))], **kw)
        _histories_close(run, ref)
        assert run.residual < 1e-9


def test_default_steps_grow_with_fault_distances():
    sim = Simulator(G16, SimConfig(), device="cpu")
    ref = RefSimulator(G16_REF, RefConfig())
    fs = R.random_faults(G16_REF, k_links=4, seed=3)
    assert sim.default_steps() == ref.default_steps()
    assert sim.default_steps(events=[(5, _pfs(fs))]) == \
        ref.default_steps(events=[(5, fs)])
    assert sim.default_steps(events=[(5, _pfs(fs))]) > sim.default_steps()


def test_static_fault_theta_matches_analytic_below_knee():
    fs = P.random_faults(G16, k_links=3, seed=1)
    ref = P.degraded_report(G16, "uniform", fs, device="cpu").theta
    sim = Simulator(G16, SimConfig(routing="minimal"), device="cpu")
    run = sim.run(_uniform(G16_REF), offered=0.9 * ref, steps=240,
                  window=60, events=[(0, fs)])
    assert run.theta / run.offered == pytest.approx(1.0, abs=0.01)
    run = sim.run(_uniform(G16_REF), offered=1.15 * ref, steps=240,
                  window=60, events=[(0, fs)])
    assert run.theta / run.offered < 0.99


def test_simulate_takes_events():
    fs = P.random_faults(G16, k_links=2, seed=0)
    run = simulate(G16, "uniform", offered=0.2, steps=60, events=[(20, fs)],
                   device="cpu")
    assert run.faults == fs.label and run.residual < 1e-9


# ---------------------------------------------------------------------------
# The knee parity seam: static == mid-run within 2.5 %
# ---------------------------------------------------------------------------


def _knee_parity(g, steps, event_frac=0.4, seed=0):
    fs = P.random_faults(g, k_links=2, seed=seed)
    ref = P.degraded_report(g, "uniform", fs, routing="minimal",
                            device="cpu").theta
    loads = np.array([0.96, 1.05]) * ref
    kw = dict(loads=loads, refine=2, theta_analytic=ref, steps=steps,
              device="cpu")
    static = saturation_sweep(g, "uniform", "minimal", events=[(0, fs)],
                              **kw)
    dynamic = saturation_sweep(g, "uniform", "minimal",
                               events=[(int(event_frac * steps), fs)], **kw)
    return static, dynamic


def test_knee_parity_static_vs_dynamic_torus():
    static, dynamic = _knee_parity(torus3d_graph(8, 16, 1), steps=648)
    assert abs(static.theta - dynamic.theta) / static.theta <= 0.025
    assert all(r.faults is not None for r in static.runs + dynamic.runs)


@pytest.mark.parametrize("backend,ref_backend", [("dense", "numpy"),
                                                 ("fused", "pallas")])
def test_midrun_fault_where_reference_goes_nonfinite(backend, ref_backend):
    """PN(8), every source to the 73 points, five dead links at step 16
    under ugal_threshold(0) at 0.96 of the degraded theta, infinite
    buffers: three steps after the fault a PEND row sum of the reference
    rounds below zero, its drain goes negative and the occupancy to
    inf / NaN (the fault ROADMAP.md queue 3 names for finite buffers).
    The port clamps that sum at zero: it stays finite and conserving,
    and equals the reference on every step before the reference's
    conservation identity breaks."""
    g_ref = R.pn_graph(8)
    npts = 73
    dem = np.zeros((g_ref.n, g_ref.n))
    dem[:, :npts] = 1.0
    np.fill_diagonal(dem, 0.0)
    dem = normalize_demand(dem)
    ref_fs = R.random_faults(g_ref, k_links=5, seed=0)
    theta = R.degraded_report(g_ref, dem, ref_fs, routing="ugal").theta
    kw = dict(offered=0.96 * theta, steps=40)
    with np.errstate(all="ignore"):
        ref = RefSimulator(g_ref, RefConfig(routing="ugal_threshold(0)",
                                            backend=ref_backend,
                                            dtype="float64"),
                           demand=dem).run(dem, events=[(16, ref_fs)], **kw)
    run = Simulator(P.pn_graph(8), SimConfig(routing="ugal_threshold(0)",
                                             backend=backend,
                                             dtype="float64"),
                    demand=dem, device="cpu").run(
        dem, events=[(16, _pfs(ref_fs))], **kw)
    for key in KEYS:
        assert np.isfinite(run.history[key]).all(), key
    assert run.residual <= 1e-9
    h = ref.history
    with np.errstate(all="ignore"):
        defect = np.abs((np.cumsum(h["offered"]) - np.cumsum(h["delivered"]))
                        * dem.sum() - h["occupancy"] - h["src_backlog"])
    bad = np.nonzero(~(defect <= 1e-9 * np.cumsum(h["offered"])
                       * dem.sum()))[0]
    assert len(bad) and 16 < bad[0] < 40     # the reference does break
    upto = int(bad[0])
    for key in KEYS:
        np.testing.assert_allclose(run.history[key][:upto],
                                   h[key][:upto], rtol=1e-9, atol=1e-12,
                                   err_msg=key)
