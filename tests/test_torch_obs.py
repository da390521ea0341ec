"""repro_torch.obs against repro.obs: span tracing, the metrics registry,
the simulator's bit-exact conservation counters, the obs-off no-op fast
path, and the hooks the port's paths carry (the reference's
``test_obs.py``, less its six ``benchmarks.compare`` tests, plus the
port's hook tests).

The counter tests are the load-bearing ones: the port's simulator
publishes its conservation totals from the SAME floats its own
residual/alpha identities consume, so recomputing those identities from
the counters must equal the returned SimRun's fields EXACTLY (==, not
approx), on PN(16), on the 8x16 torus, and through a mid-run fault
event.  Against the reference's counters (its ``backend="numpy"``, the
dense float64 oracle; never its ``jax`` or ``auto``) the port's dense
float64 counters agree at the dense-parity tolerance of
``test_torch_sim.py`` (rtol 1e-9), on PN(8) and the faulted torus: a
PN(16) step costs about a second on the CPU on either side.  The util / routing / faults /
adversary counters run the port's ``dense`` engine against the
reference's ``numpy`` engine and must count the same work.
"""

from __future__ import annotations

import json
import tracemalloc

import numpy as np
import pytest
import torch

import repro.core as R
from repro import obs as robs
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
from repro.sim import SimConfig as RefConfig
from repro.sim import Simulator as RefSimulator
from repro_torch import obs
from repro_torch.core import FaultSet, pn_graph, random_faults
from repro_torch.fabric import torus3d_graph
from repro_torch.obs import MetricsRegistry, balance_stats
from repro_torch.sim import SimConfig, Simulator

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_stack():
    """Tiny CPU products: torch's thread pool only adds latency here.
    Every session a test opens is closed by the time it ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert obs.current() is None
    yield
    torch.set_num_threads(n)
    assert obs.current() is None, "a test left an obs session open"


def _uniform(g):
    d = np.ones((g.n, g.n)) - np.eye(g.n)
    return d / d.sum(axis=1, keepdims=True)


def _close(got, want, rtol=RTOL, atol=1e-12):
    """test_torch_sim.py's dense-parity tolerance (rtol 1e-9, atol
    1e-12): both sides run the same float64 algebra in different
    summation orders."""
    assert abs(got - want) <= atol + rtol * abs(want), (got, want)


# -- tracing ---------------------------------------------------------------


def test_span_nesting_and_chrome_trace(tmp_path):
    with obs.session(mode="trace") as sess:
        with obs.span("outer.work", n=3):
            with obs.span("inner.work"):
                pass
            with obs.span("inner.work"):
                pass
    assert [e[0] for e in sess.events] == ["inner.work", "inner.work",
                                           "outer.work"]  # close order
    depths = {e[0]: e[4] for e in sess.events}
    assert depths["outer.work"] == 0 and depths["inner.work"] == 1
    summ = sess.span_summary()
    assert summ["inner.work"]["count"] == 2
    assert summ["outer.work"]["total_s"] >= summ["inner.work"]["total_s"]

    path = tmp_path / "trace.json"
    sess.write_chrome(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M"                       # process_name metadata
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == 3
    outer = next(e for e in xs if e["name"] == "outer.work")
    assert outer["args"] == {"n": 3}
    for e in xs:                                     # Perfetto essentials
        assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)

    jl = tmp_path / "trace.jsonl"
    sess.write_jsonl(str(jl))
    lines = [json.loads(ln) for ln in jl.read_text().splitlines()]
    assert lines[0]["schema"] == "repro.obs/1"
    assert len(lines) == 4
    # the snapshot schema is the reference's, letter for letter
    assert sess.snapshot()["schema"] == robs.Session("trace").snapshot()[
        "schema"]


def test_timed_measures_with_obs_off():
    assert obs.current() is None
    with obs.timed("standalone.step") as sp:
        sum(range(1000))
    assert sp.seconds > 0
    # a CPU tensor, a CPU device and plain values register nothing to
    # wait on; the span still measures
    with obs.timed("standalone.sync") as sp:
        sp.sync({"w": torch.ones(3)}, [torch.device("cpu"), 1.0], None)
    assert sp.seconds > 0


def test_metrics_mode_records_no_spans():
    with obs.session(mode="metrics") as sess:
        with obs.span("should.be.noop"):
            obs.counter("c").add(2.0)
    assert sess.events == []
    assert sess.metrics.counter("c").value == 2.0


def test_session_modes_validate():
    with pytest.raises(ValueError, match="unknown obs mode"):
        with obs.session(mode="bogus"):
            pass
    with obs.session(mode="none") as sess:
        assert not sess.enabled
        assert sess.snapshot() is None
    # a block that raises still leaves the stack
    with pytest.raises(RuntimeError, match="boom"):
        with obs.session(mode="trace"):
            raise RuntimeError("boom")
    assert obs.current() is None


# -- metrics registry ------------------------------------------------------


def test_registry_kinds_and_mismatch():
    reg = MetricsRegistry()
    reg.counter("a").add(1.5)
    reg.counter("a").add(1.5)                 # get-or-create, same object
    reg.gauge("g").set(7.0)
    reg.histogram("h").observe_many([1.0, 2.0, 3.0])
    reg.series("s").append(1.0)
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("a")
    snap = reg.snapshot()
    assert snap["a"] == {"type": "counter", "value": 3.0}
    assert snap["g"] == {"type": "gauge", "value": 7.0}
    assert snap["h"]["count"] == 3 and snap["h"]["p50"] == 2.0
    assert snap["s"] == {"type": "series", "count": 1, "mean": 1.0,
                         "min": 1.0, "max": 1.0, "last": 1.0}


def test_balance_stats_known_inputs():
    flat = balance_stats(np.ones(100))
    assert flat["gini"] == pytest.approx(0.0, abs=1e-12)
    assert flat["max_over_mean"] == pytest.approx(1.0)
    assert flat["p99_over_mean"] == pytest.approx(1.0)
    # one link carries everything: gini -> (n-1)/n
    onehot = balance_stats([0.0] * 99 + [1.0])
    assert onehot["gini"] == pytest.approx(0.99)
    assert onehot["max_over_mean"] == pytest.approx(100.0)
    assert balance_stats([])["gini"] == 0.0
    assert balance_stats([0.0, 0.0])["max_over_mean"] == 1.0
    x = np.random.default_rng(0).random(257)
    assert balance_stats(x) == robs.balance_stats(x)


# -- simulator counters: bit-exact with SimRun -----------------------------


def _counters_match_run(sess, run):
    """Recompute SimRun's residual/alpha identities from the published
    counters; every comparison is EXACT (same floats, same ops)."""
    m = sess.metrics
    inj = m.counter("sim.injected").value
    dlv = m.counter("sim.delivered").value
    acc = m.counter("sim.accepted").value
    div = m.counter("sim.diverted").value
    drop = m.counter("sim.dropped").value
    occ = m.get("sim.final_occupancy").value
    src = m.get("sim.final_src_backlog").value
    assert drop == run.dropped
    assert m.get("sim.residual").value == run.residual
    assert m.get("sim.alpha").value == run.alpha
    assert abs(inj - dlv - occ - src - drop) / max(inj, 1e-30) \
        == run.residual
    assert 1.0 - div / max(acc, 1e-30) == run.alpha
    assert m.get("sim.theta").value == run.theta
    assert run.residual < 1e-9


_CONSERVATION = ("sim.injected", "sim.delivered", "sim.accepted",
                 "sim.diverted", "sim.dropped", "sim.final_occupancy",
                 "sim.final_src_backlog", "sim.alpha", "sim.theta",
                 "sim.delivered_rate")


def _counters_match_reference(sess, ref_sess):
    m, rm = sess.metrics, ref_sess.metrics
    for name in _CONSERVATION:
        _close(m.get(name).value, rm.get(name).value)
    for name in ("sim.runs", "sim.steps", "sim.fault_events"):
        assert (m.get(name) is None) == (rm.get(name) is None), name
        if m.get(name) is not None:
            assert m.get(name).value == rm.get(name).value, name


def test_sim_counters_bit_exact_pn16():
    g = pn_graph(16)
    sim = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                 backend="dense"), device="cpu")
    with obs.session(mode="metrics") as sess:
        run = sim.run(_uniform(g), offered=0.3, steps=24, window=8)
    _counters_match_run(sess, run)
    assert sess.metrics.counter("sim.steps").value == 24.0
    assert sess.metrics.counter("sim.runs").value == 1.0
    # final-state link utilization + balance publish even without series
    snap = sess.snapshot()
    assert snap["metrics"]["sim.link_util_final"]["count"] == \
        len(run.link_util) > 0
    assert 0.0 <= snap["metrics"]["sim.balance.gini"]["value"] < 1.0


def test_sim_counters_match_reference_pn8():
    g, rg = pn_graph(8), R.pn_graph(8)
    sim = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                 backend="dense"), device="cpu")
    with obs.session(mode="metrics") as sess:
        run = sim.run(_uniform(g), offered=0.3, steps=120, window=30)
    _counters_match_run(sess, run)
    rsim = RefSimulator(rg, RefConfig(routing="ugal_threshold(0)",
                                      backend="numpy"))
    with robs.session(mode="metrics") as rsess:
        rsim.run(_uniform(rg), offered=0.3, steps=120, window=30)
    _counters_match_reference(sess, rsess)
    for name in ("sim.balance.gini", "sim.balance.max_over_mean",
                 "sim.balance.p99_over_mean"):
        assert abs(sess.metrics.get(name).value
                   - rsess.metrics.get(name).value) <= 1e-9, name


def test_sim_counters_bit_exact_torus_with_fault_event():
    g, rg = torus3d_graph(8, 16, 1), ref_torus3d_graph(8, 16, 1)
    fs, rfs = (random_faults(g, k_links=3, seed=1),
               R.random_faults(rg, k_links=3, seed=1))
    assert fs.label == rfs.label
    sim = Simulator(g, SimConfig(routing="minimal"), device="cpu")
    with obs.session(mode="metrics") as sess:
        run = sim.run(_uniform(g), offered=0.2, steps=160, window=40,
                      events=[(60, fs)])
    _counters_match_run(sess, run)
    assert sess.metrics.counter("sim.fault_events").value == 1.0
    rsim = RefSimulator(rg, RefConfig(routing="minimal", backend="numpy"))
    with robs.session(mode="metrics") as rsess:
        rsim.run(_uniform(rg), offered=0.2, steps=160, window=40,
                 events=[(60, rfs)])
    _counters_match_reference(sess, rsess)


def test_sim_router_fault_drop_counter_exact():
    g = pn_graph(8)
    sim = Simulator(g, SimConfig(routing="ugal_threshold(0)"), device="cpu")
    with obs.session(mode="trace") as sess:
        run = sim.run(_uniform(g), offered=0.3, steps=150, window=40,
                      events=[(50, FaultSet(routers=[5]))])
    assert run.dropped > 0
    _counters_match_run(sess, run)
    spans = sess.span_summary()
    assert spans["sim.fault_surgery"]["count"] == 1
    assert spans["sim.fault_tables"]["count"] == 1


def test_sim_series_capture_under_trace():
    g = pn_graph(8)
    with obs.session(mode="trace") as sess:
        # built inside the session so the sim.build_tables span records
        sim = Simulator(g, SimConfig(routing="ugal_threshold(0)"),
                        device="cpu")
        run = sim.run(_uniform(g), offered=0.3, steps=80, window=20)
    m = sess.metrics
    assert len(m.series("sim.occ_vc0")) == 80
    assert len(m.series("sim.src_backlog")) == 80
    # the per-step occupancy series sums to the history's occupancy
    occ = (np.asarray(m.series("sim.occ_vc0"))
           + np.asarray(m.series("sim.occ_vc1"))
           + np.asarray(m.series("sim.occ_vc2")))
    np.testing.assert_allclose(occ, run.history["occupancy"], rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(m.series("sim.src_backlog")),
                                  run.history["src_backlog"])
    snap = sess.snapshot()
    assert snap["metrics"]["sim.link_util"]["count"] > 0
    assert snap["metrics"]["sim.dest_stability"]["count"] == g.n
    # uniform demand well below the knee: every dest column is stable
    assert snap["metrics"]["sim.dest_stability.min"]["value"] > 0.9
    names = [e[0] for e in sess.events]
    assert "sim.run" in names and "sim.build_tables" in names
    # the same capture as the reference's, at the dense-parity tolerance
    rg = R.pn_graph(8)
    with robs.session(mode="trace") as rsess:
        RefSimulator(rg, RefConfig(routing="ugal_threshold(0)",
                                   backend="numpy")).run(
            _uniform(rg), offered=0.3, steps=80, window=20)
    for name in ("sim.occ_vc0", "sim.occ_vc1", "sim.occ_vc2",
                 "sim.diverted_frac", "sim.inj_stalled"):
        np.testing.assert_allclose(np.asarray(m.series(name)),
                                   np.asarray(rsess.metrics.series(name)),
                                   rtol=RTOL, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(
        np.sort(m.histogram("sim.dest_stability").values),
        np.sort(rsess.metrics.histogram("sim.dest_stability").values),
        rtol=RTOL)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_obs_on_leaves_the_run_bit_for_bit(backend, tmp_path):
    """No session, metrics, and trace with series, a recorder and a
    watchdog give the same SimRun, every field and history bit for
    bit."""
    g = pn_graph(7)
    dem = _uniform(g)
    sim = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                 backend=backend), device="cpu")
    runs = [sim.run(dem, 0.9, steps=40)]
    with obs.session(mode="metrics"):
        runs.append(sim.run(dem, 0.9, steps=40))
    wd = obs.Watchdog([obs.residual(), obs.nonfinite(), obs.step_time(),
                       obs.dest_stability(window=8, warmup=8)],
                      dir=str(tmp_path))
    with obs.session(mode="trace", series=True,
                     recorder=obs.FlightRecorder(16), watchdog=wd) as sess:
        runs.append(sim.run(dem, 0.9, steps=40))
    assert not wd.fired
    assert len(sess.recorder) == 16
    base = runs[0]
    for r in runs[1:]:
        for key, val in vars(base).items():
            got = getattr(r, key)
            if key == "history":
                assert got.keys() == val.keys()
                for k in val:
                    np.testing.assert_array_equal(got[k], val[k])
            elif isinstance(val, np.ndarray):
                np.testing.assert_array_equal(got, val)
            elif isinstance(val, float) and np.isnan(val):
                assert np.isnan(got), key
            else:
                assert got == val, key


# -- the obs-off fast path -------------------------------------------------


def test_null_span_singleton_and_no_allocation():
    assert obs.current() is None
    assert obs.span("a") is obs.span("b") is obs.NULL_SPAN
    assert obs.counter("x") is obs.gauge("y") is obs.NULL_METRIC
    # no session: no recorder, no watchdog, and emit is a silent no-op
    assert obs.recorder() is None and obs.watchdog() is None
    obs.emit("nobody", listening=True)

    def seam():
        # the exact shape of every instrumented hot-loop seam
        with obs.span("hot.loop", k=1):
            obs.counter("hot.count").add(1.0)
        if obs.recorder() is not None or obs.watchdog() is not None:
            raise AssertionError("no session: hooks must stay None")
        obs.emit("hot.event", k=1)

    seam()  # warm up any lazy caches
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(200):
        seam()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    growth = sum(s.size_diff for s in after.compare_to(before, "filename")
                 if s.size_diff > 0)
    # 200 no-op seams must not accumulate memory: a handful of KB covers
    # tracemalloc's own bookkeeping noise, while a real per-call record
    # (one dict + one tuple each) would exceed it several-fold
    assert growth < 8192, f"obs=none seam leaked {growth} B over 200 calls"


def test_session_default_mode_is_none(monkeypatch):
    """The port has no perf flags: mode=None is "none" whatever the
    environment says (it reads no REPRO_PERF)."""
    monkeypatch.setenv("REPRO_PERF", "obs=trace")
    with obs.session() as sess:
        assert sess is obs.NULL_SESSION and not sess.enabled
        assert obs.current() is None


# -- the hooks of the port's paths -----------------------------------------


def test_sim_build_counters_and_gauges():
    g = pn_graph(7)
    dem = np.zeros((g.n, g.n))
    dem[0, 5] = dem[3, 9] = 1.0
    with obs.session(mode="trace") as sess:
        Simulator(g, SimConfig(routing="minimal"), device="cpu")
        Simulator(g, SimConfig(routing="ugal_threshold(0)",
                               backend="fused"), demand=dem, device="cpu")
    m = sess.metrics
    assert m.counter("sim.step_build[dense]").value == 1.0
    assert m.counter("sim.step_build[fused_plain]").value == 1.0
    assert m.counter("sim.step_build[fused_decision]").value == 1.0
    assert "sim.step_build[fused_cuda]" not in m
    assert m.counter("sim.backend[dense]").value == 1.0
    assert m.counter("sim.backend[fused]").value == 1.0
    # the last build: ugal keeps the active set whole, compacts the dests
    assert m.gauge("sim.dest_cols.dense").value == float(g.n)
    assert m.gauge("sim.dest_cols.compacted").value == 2.0
    assert m.gauge("sim.compact_ratio").value == 2.0 / g.n
    assert sess.span_summary()["sim.build_tables"]["count"] == 2


def test_saturation_sweep_probes_and_stream(tmp_path):
    from repro.sim import saturation_sweep as ref_sweep
    from repro_torch.sim import saturation_sweep
    from repro_torch.core import saturation_report
    g, rg = pn_graph(5), R.pn_graph(5)
    th = saturation_report(g, "uniform", routing="minimal",
                           device="cpu").theta
    kw = dict(routing="minimal", loads=[0.5 * th, 0.9 * th, 1.3 * th],
              steps=60, refine=2, theta_analytic=th)
    path = str(tmp_path / "telemetry.jsonl")
    with obs.session(mode="trace", stream=path) as sess:
        sw = saturation_sweep(g, "uniform", device="cpu", **kw)
    m = sess.metrics
    assert m.counter("sim.probes[grid]").value == 3.0
    assert m.counter("sim.probes[bisect]").value == 2.0
    assert "sim.probes[bracket]" not in m
    spans = sess.span_summary()
    assert spans["sim.sweep"]["count"] == 1
    assert spans["sim.probe"]["count"] == spans["sim.run"]["count"] \
        == len(sw.runs) == 5
    events = [json.loads(ln) for ln in open(path)][1:]
    assert [e["kind"] for e in events] == ["sim.probe"] * 5
    assert [e["probe"] for e in events] == [1, 2, 3, 4, 5]
    with robs.session(mode="metrics") as rsess:
        ref_sweep(rg, "uniform", config=RefConfig(backend="numpy"), **kw)
    for phase in ("grid", "bisect"):
        name = f"sim.probes[{phase}]"
        assert m.get(name).value == rsess.metrics.get(name).value


def _port_names(snapshot: dict) -> dict:
    """A reference snapshot's counters under the port's engine names."""
    return {k.replace("[numpy]", "[dense]"): v["value"]
            for k, v in snapshot.items() if v["type"] == "counter"}


@pytest.mark.parametrize("pattern", ["uniform", "tornado",
                                     "hot_region(0.2,4)"])
def test_util_and_routing_counters_match_reference(pattern):
    from repro.core import routing as RR
    from repro.core.traffic import make_pattern as ref_make_pattern
    from repro.core.traffic import normalize_demand
    from repro_torch.core import routing as PR
    rg, g = R.pn_graph(7), pn_graph(7)
    demand = normalize_demand(ref_make_pattern(pattern).demand(rg, None))
    active = np.arange(g.n)
    models = ("minimal", "valiant", "ugal")
    with obs.session(mode="trace") as sess:
        out = PR.evaluate_models(g, demand, active, models, engine="dense",
                                 device="cpu")
    with robs.session(mode="trace") as rsess:
        want = RR.evaluate_models(rg, demand, active, models,
                                  engine="numpy")
    for name in models:
        _close(out[name].max_load, want[name].max_load)
    counters = {k: v["value"] for k, v in sess.snapshot()["metrics"].items()
                if v["type"] == "counter"}
    assert counters == _port_names(rsess.snapshot()["metrics"])
    assert counters["routing.blend.solves"] == 1.0
    spans = {k: v["count"] for k, v in sess.span_summary().items()}
    assert spans == {k: v["count"] for k, v in rsess.span_summary().items()}
    assert set(spans) == {"routing.evaluate_models", "routing.sweep[minimal]",
                          "routing.sweep[valiant]", "util.arc_loads_weighted"}


def test_util_engine_counters_name_the_engine_that_ran():
    from repro_torch.core import arc_loads, arc_loads_weighted
    g = pn_graph(5)
    with obs.session(mode="metrics") as sess:
        arc_loads(g, engine="auto", device="cpu")          # orbit shortcut
        arc_loads(g, sources=[0, 1], engine="auto", device="cpu")
        arc_loads(g, engine="fused", device="cpu")
        d = np.random.default_rng(0).random((g.n, g.n))
        arc_loads_weighted(g, d, engine="auto", device="cpu")
    c = {k: v["value"] for k, v in sess.snapshot()["metrics"].items()}
    assert c == {"util.dispatch[auto]": 3.0, "util.dispatch[fused]": 1.0,
                 "util.engine[dense]": 3.0, "util.engine[orbit]": 1.0}


def test_faults_and_adversary_counters_match_reference(tmp_path):
    from repro_torch.core import (degradation_sweep, targeted_faults,
                                  worst_case)
    g, rg = pn_graph(5), R.pn_graph(5)
    path = str(tmp_path / "faults.jsonl")
    with obs.session(mode="trace", stream=path) as sess:
        fs = targeted_faults(g, k=2, engine="dense", device="cpu")
        degradation_sweep(g, k_failures=(0, 1, 2), trials=2,
                          engine="dense", device="cpu")
        worst_case(g, "ugal", n_random=2, engine="dense", device="cpu")
    with robs.session(mode="trace") as rsess:
        rfs = R.targeted_faults(rg, k=2, engine="numpy")
        R.degradation_sweep(rg, k_failures=(0, 1, 2), trials=2,
                            engine="numpy")
        R.worst_case(rg, "ugal", n_random=2, engine="numpy")
    # every PN(5) link carries the same load: the two packages may break
    # that tie otherwise, so the fault sets are not compared
    assert len(fs.links) == len(rfs.links) == 2
    snap, rsnap = sess.snapshot()["metrics"], rsess.snapshot()["metrics"]
    for name in ("faults.targeted_rounds", "adversary.candidates",
                 "faults.trials.done", "adversary.candidates.done"):
        assert snap[name]["value"] == rsnap[name]["value"], name
    assert snap["faults.targeted_rounds"]["value"] == 2.0
    assert snap["faults.trials.done"]["value"] == 6.0
    spans = sess.span_summary()
    for name in ("faults.targeted", "faults.degradation_sweep",
                 "adversary.search", "adversary.candidate"):
        assert spans[name]["count"] == rsess.span_summary()[name]["count"]
    events = [json.loads(ln) for ln in open(path)][1:]
    labels = [e["label"] for e in events if e["kind"] == "progress"]
    assert labels.count("faults.trials") == 6
    assert labels.count("adversary.candidates") == \
        snap["adversary.candidates"]["value"]


def test_placement_swap_evals_equal_history():
    from repro_torch.fabric import (collective_traffic, greedy_improve,
                                    place_mesh)
    g = pn_graph(5)
    mesh, axes = (4, 8), ("data", "model")
    p0 = place_mesh(g, mesh, axes, 2, "random", seed=3, device="cpu")
    traffic = collective_traffic(mesh, axes, {"data": ("ring", 1.0),
                                              "model": ("all_to_all", 1.0)})
    iters, seed = 40, 4
    with obs.session(mode="trace") as sess:
        _, best, hist = greedy_improve(p0, traffic, iters=iters, seed=seed,
                                       return_history=True, device="cpu")
    # the descent evaluates every drawn pair whose chips sit on two
    # routers, and keeps a swap exactly where the history drops
    pairs = np.random.default_rng(seed).integers(0, p0.n_chips, (iters, 2))
    cur, evals, kept = p0.router_of.copy(), 0, 0
    for (i, j), before, after in zip(pairs, hist, hist[1:]):
        if cur[i] != cur[j]:
            evals += 1
        if after < before:
            kept += 1
            cur[i], cur[j] = cur[j], cur[i]
    m = sess.metrics
    assert m.counter("placement.swap_evals").value == evals > 0
    assert m.counter("placement.swap_accepted").value == kept > 0
    ev = [e for e in sess.events if e[0] == "placement.greedy_swap"]
    assert len(ev) == 1 and ev[0][5]["best"] == best == hist[-1]


def test_train_step_spans_one_per_step(tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_arch("smollm-135m").reduced()
    tr = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=16,
                                 global_batch=2),
                 TrainerConfig(total_steps=3, checkpoint_every=100,
                               checkpoint_dir=str(tmp_path), log_every=100),
                 device="cpu")
    with obs.session(mode="trace") as sess:
        tr.run()
    ev = [e for e in sess.events if e[0] == "train.step"]
    assert [e[5]["step"] for e in ev] == [0, 1, 2]
    # the trainer's step times are the spans' own
    assert [e[2] / 1e9 for e in ev] == [h.seconds for h in tr.history]


def test_serve_run_span_one_per_run():
    from repro_torch.launch.serve import serve
    with obs.session(mode="trace") as sess:
        results, seconds, _ = serve("smollm-135m", requests=2, max_new=2,
                                    max_batch=2, max_len=32, device="cpu")
    assert len(results) == 2
    ev = [e for e in sess.events if e[0] == "serve.run"]
    assert len(ev) == 1 and ev[0][5] == {"requests": 2}
    assert ev[0][2] / 1e9 == seconds
    # with obs off the launcher times the same bracket
    _, seconds, _ = serve("smollm-135m", requests=1, max_new=1,
                          max_batch=1, max_len=32, device="cpu")
    assert seconds > 0


@pytest.mark.cuda
def test_span_sync_waits_on_the_card():
    """A timed span with a CUDA tensor registered closes only after the
    card has run the work queued on it: its seconds cover the work's
    CUDA-event time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: Span.sync waits on the card")
    a = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with obs.timed("card.work") as sp:
        start.record()
        b = a
        for _ in range(20):
            b = b @ a
        end.record()
        sp.sync({"out": [b]})
    assert end.query()
    assert sp.seconds * 1e3 >= start.elapsed_time(end)
