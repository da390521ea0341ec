"""Flight recorder, watchdog triggers, streaming export and HTML report of
repro_torch.obs (the reference's ``test_recorder_watchdog.py``, test for
test), plus the port's own: the monitor's halt against the reference's,
and the files of either package loading in the other.

The heavyweight anchor is the postmortem e2e: a past-knee
``ugal_threshold`` probe on PN(16) MUST fire the dest-stability
watchdog, and the reloaded bundle's ring-buffer channels MUST replay the
port's own ``SimRun.history`` bit-exactly (float64 through JSON via
shortest-repr).  Everything else drives the triggers directly through
synthetic samples.
"""

import json
import math
import os
import threading

import numpy as np
import pytest
import torch

import repro.core as R
from repro import obs as robs
from repro.obs import report as ref_report
from repro.sim import SimConfig as RefConfig
from repro.sim import Simulator as RefSimulator
from repro_torch import obs
from repro_torch.core import pn_graph
from repro_torch.obs import report as obs_report
from repro_torch.sim import SimConfig, Simulator

KEYS = ("delivered", "accepted", "offered", "occupancy", "src_backlog",
        "diverted")


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


# -- flight recorder -------------------------------------------------------


def test_recorder_ring_semantics():
    rec = obs.FlightRecorder(window=4)
    assert len(rec) == 0 and rec.channels == [] and rec.window_arrays() == {}
    for i in range(10):
        rec.record(i, {"b": float(i), "a": float(-i)})
    assert rec.channels == ["a", "b"]        # fixed sorted on first record
    assert len(rec) == 4 and rec.count == 10
    win = rec.window_arrays()
    assert win["step"].tolist() == [6, 7, 8, 9]   # oldest first, wrapped
    assert win["b"].tolist() == [6.0, 7.0, 8.0, 9.0]
    assert win["a"].tolist() == [-6.0, -7.0, -8.0, -9.0]
    # a later call missing a fixed channel raises instead of writing NaN
    with pytest.raises(KeyError):
        rec.record(10, {"b": 1.0})
    rec.reset()
    assert len(rec) == 0 and rec.channels == []


def test_recorder_partial_window_and_snapshot_roundtrip():
    rec = obs.FlightRecorder(window=8)
    vals = [0.1, 1 / 3, math.pi, 1e-300]
    for i, v in enumerate(vals):
        rec.record(i, {"x": v})
    win = rec.window_arrays()
    assert win["step"].tolist() == [0, 1, 2, 3]
    snap = json.loads(json.dumps(rec.snapshot()))
    assert snap["schema"] == "repro.obs/recorder/1"
    assert snap["window"] == 8 and snap["count"] == 4
    # float64 -> json -> float64 is bit-exact (shortest-repr round-trip)
    assert np.array_equal(np.asarray(snap["channels"]["x"]), win["x"])


def test_recorder_window_validation():
    with pytest.raises(ValueError):
        obs.FlightRecorder(window=0)


# -- watchdog triggers (synthetic samples) ---------------------------------


def _sample(step, **kw):
    base = {"step": step, "delivered": 1.0, "accepted": 1.0,
            "offered": 1.0, "occupancy": 0.5, "src_backlog": 0.0,
            "diverted": 0.0, "residual": 0.0}
    base.update(kw)
    return base


def test_residual_trigger_warmup_and_bundle(tmp_path):
    wd = obs.Watchdog([obs.residual(tol=1e-6, warmup=4)],
                      dir=str(tmp_path))
    wd.begin_run(backend="test", offered=1.0)
    wd.on_step(_sample(0, residual=1.0))    # inside warmup: armed, silent
    assert not wd.fired
    wd.on_step(_sample(5, residual=1e-3))
    assert len(wd.fired) == 1
    name, path = wd.fired[0]
    assert name == "residual" and os.path.exists(path)
    bundle = obs.load_bundle(path)
    assert bundle["schema"] == "repro.obs/postmortem/1"
    assert bundle["trigger"] == {"name": "residual", "tol": 1e-6,
                                 "warmup": 4}
    assert "residual" in bundle["reason"]
    assert bundle["context"]["backend"] == "test"
    assert bundle["sample"]["step"] == 5
    # one bundle per trigger: the same anomaly does not dump again
    wd.on_step(_sample(6, residual=1e-3))
    assert len(wd.fired) == 1 and wd.exhausted


def test_nonfinite_trigger_nan_and_negative_mass(tmp_path):
    wd = obs.Watchdog([obs.nonfinite()], dir=str(tmp_path))
    wd.on_step(_sample(0, delivered=float("nan")))
    assert wd.fired and "non-finite" in wd.last_bundle["reason"]
    wd2 = obs.Watchdog([obs.nonfinite()], dir=None)
    wd2.on_step(_sample(3, occupancy=-1e-3))
    assert wd2.fired[0] == ("nonfinite", None)   # dir=None: in-memory only
    assert "negative mass" in wd2.last_bundle["reason"]
    wd3 = obs.Watchdog([obs.nonfinite()], dir=None)
    wd3.on_step(_sample(1, dest_mass_min=-1.0))
    assert "per-dest" in wd3.last_bundle["reason"]


def test_step_time_trigger_spike(tmp_path):
    wd = obs.Watchdog([obs.step_time(factor=10.0, warmup=4,
                                     floor_s=0.01)], dir=None)
    for i in range(8):
        wd.on_step(_sample(i, step_seconds=0.001))
    assert not wd.fired
    wd.on_step(_sample(8, step_seconds=0.5))     # 500x the running mean
    assert wd.fired and "running mean" in wd.last_bundle["reason"]


def test_dest_stability_trigger_reads_digest(tmp_path):
    wd = obs.Watchdog([obs.dest_stability(ratio=0.5, window=8, warmup=4)],
                      dir=None)
    assert wd.needs("dest_mass") and wd.stability_window() == 8
    assert not wd.needs("step_seconds")
    # below warmup+window: silent even with a collapsed digest
    wd.on_step(_sample(5, dest_stability_min=0.1, dest_stability_col=3))
    assert not wd.fired
    wd.on_step(_sample(12, dest_stability_min=0.1, dest_stability_col=3))
    assert wd.fired and "(dest col 3)" in wd.last_bundle["reason"]
    # once fired, the monitor may drop the digest entirely
    assert not wd.needs("dest_mass") and wd.stability_window() is None


def test_oscillation_trigger_on_probe(tmp_path):
    wd = obs.Watchdog([obs.oscillation()], dir=str(tmp_path))
    wd.on_probe(2.0, stable=True)     # fine: stable below any collapse
    wd.on_probe(3.0, stable=False)    # the frontier
    wd.on_probe(2.5, stable=True)     # fine: below the collapsed load
    assert not wd.fired
    wd.on_probe(3.5, stable=True)     # stable ABOVE a collapsed probe
    assert wd.fired[0][0] == "oscillation"
    assert "non-monotone" in wd.last_bundle["reason"]
    assert wd.fired[0][1].endswith("postmortem_oscillation_probe.json")


def test_watchdog_halt_raises(tmp_path):
    wd = obs.Watchdog([obs.residual(tol=1e-6, warmup=0)], action="halt",
                      dir=str(tmp_path))
    with pytest.raises(obs.WatchdogFired) as ei:
        wd.on_step(_sample(1, residual=1.0))
    assert ei.value.trigger == "residual" and ei.value.path is not None
    assert os.path.exists(ei.value.path)


def test_watchdog_max_bundles_and_begin_run_rearm(tmp_path):
    wd = obs.Watchdog([obs.residual(tol=1e-6, warmup=0),
                       obs.nonfinite()], dir=str(tmp_path), max_bundles=1)
    wd.on_step(_sample(1, residual=1.0))
    assert len(wd.fired) == 1 and wd.exhausted
    # exhausted: the second trigger can no longer dump
    wd.on_step(_sample(2, delivered=float("nan")))
    assert len(wd.fired) == 1
    # begin_run re-arms only unfired triggers
    wd.begin_run()
    assert wd.triggers[0].fired and not wd.triggers[1].fired


def test_watchdog_rejects_unknown_action():
    with pytest.raises(ValueError):
        obs.Watchdog([], action="explode")


# -- postmortem e2e: past-knee probe fires, bundle is bit-exact ------------


def test_postmortem_e2e_past_knee_bit_exact(tmp_path):
    g = pn_graph(16)
    demand = _uniform(g)
    # pn16 uniform analytic theta ~6.97; 2x is comfortably past the knee
    offered = 2.0 * 6.9714
    rec = obs.FlightRecorder(window=24)
    wd = obs.Watchdog([obs.dest_stability(ratio=0.8, window=16, warmup=16)],
                      action="continue", dir=str(tmp_path / "pm"))
    simr = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                  backend="fused"), device="cpu")
    with obs.session(mode="metrics", recorder=rec, watchdog=wd) as sess:
        assert sess.recorder is rec and sess.watchdog is wd
        run = simr.run(demand, offered, steps=60)
    assert wd.fired, "past-knee probe must fire the dest-stability watchdog"
    name, path = wd.fired[0]
    assert name == "dest_stability"

    bundle = obs.load_bundle(path)
    assert bundle["context"]["config"]["routing"] == "ugal_threshold(0)"
    assert bundle["context"]["demand_fingerprint"]
    assert bundle["context"]["device"] == "cpu"
    # the ring window replays the run's own history arrays bit-exactly
    steps_idx = np.asarray(bundle["recorder"]["steps"], dtype=np.int64)
    assert len(steps_idx) == 24
    for key in KEYS:
        got = np.asarray(bundle["recorder"]["channels"][key])
        want = np.asarray(run.history[key], dtype=np.float64)[steps_idx]
        assert np.array_equal(got, want), f"channel {key} diverged"
    # the digest channel exists and ends collapsed (below the ratio)
    stab = bundle["recorder"]["channels"]["dest_stability_min"]
    finite = [v for v in stab if v == v]
    assert finite and min(finite) < 0.8
    # and the firing sample carries the same story
    assert bundle["sample"]["dest_stability_min"] < 0.8


def test_monitor_skips_digests_without_triggers():
    # recorder-only session: no dest-mass pass, but channels still record
    g = pn_graph(16)
    rec = obs.FlightRecorder(window=8)
    simr = Simulator(g, SimConfig(backend="fused"), device="cpu")
    with obs.session(mode="metrics", recorder=rec):
        run = simr.run(_uniform(g), 0.5, steps=20)
    assert len(rec) == 8
    assert "dest_stability_min" not in rec.channels
    win = rec.window_arrays()
    assert np.array_equal(win["delivered"],
                          np.asarray(run.history["delivered"])[win["step"]])


def test_halting_watchdog_stops_where_the_reference_does(tmp_path):
    """A halting dest_stability watchdog past the knee stops the port's
    run (dense float64) at the reference's step (backend numpy); the
    window up to that step equals the port's own history of the same run
    bit for bit, and the reference's at the dense-parity tolerance."""
    g, rg = pn_graph(8), R.pn_graph(8)
    # PN(8) uniform analytic ugal theta ~3.78; 2x is past the knee
    offered, steps = 2.0 * 3.7826, 60

    def trig():
        return [obs.dest_stability(ratio=0.8, window=8, warmup=8)]

    sim = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                 backend="dense"), device="cpu")
    full = sim.run(_uniform(g), offered, steps=steps)
    wd = obs.Watchdog(trig(), action="halt", dir=str(tmp_path / "port"))
    with pytest.raises(obs.WatchdogFired) as ei:
        with obs.session(mode="metrics", recorder=obs.FlightRecorder(32),
                         watchdog=wd):
            sim.run(_uniform(g), offered, steps=steps)
    rwd = robs.Watchdog([robs.dest_stability(ratio=0.8, window=8,
                                             warmup=8)],
                        action="halt", dir=str(tmp_path / "ref"))
    with pytest.raises(robs.WatchdogFired) as rei:
        with robs.session(mode="metrics",
                          recorder=robs.FlightRecorder(32), watchdog=rwd):
            RefSimulator(rg, RefConfig(routing="ugal_threshold(0)",
                                       backend="numpy")).run(
                _uniform(rg), offered, steps=steps)
    bundle = obs.load_bundle(ei.value.path)
    ref_bundle = robs.load_bundle(rei.value.path)
    step = bundle["sample"]["step"]
    assert step == ref_bundle["sample"]["step"] < steps - 1
    # uniform demand: every column is alike, so the argmin column is a
    # tie; its ratio is not
    np.testing.assert_allclose(bundle["sample"]["dest_stability_min"],
                               ref_bundle["sample"]["dest_stability_min"],
                               rtol=1e-9)
    idx = np.asarray(bundle["recorder"]["steps"])
    assert idx[-1] == step
    np.testing.assert_array_equal(idx, ref_bundle["recorder"]["steps"])
    for key in KEYS:
        got = np.asarray(bundle["recorder"]["channels"][key])
        assert np.array_equal(got, full.history[key][idx]), key
        np.testing.assert_allclose(
            got, ref_bundle["recorder"]["channels"][key], rtol=1e-9,
            atol=1e-12, err_msg=key)
    np.testing.assert_allclose(
        bundle["recorder"]["channels"]["dest_stability_min"],
        ref_bundle["recorder"]["channels"]["dest_stability_min"],
        rtol=1e-9, atol=1e-12)


def test_bundles_and_snapshots_load_in_either_package(tmp_path):
    """The schema tags are the reference's, letter for letter: a bundle
    either package writes loads in the other's ``load_bundle`` and
    renders in the other's report."""
    wd = obs.Watchdog([obs.residual(tol=1e-9, warmup=0)],
                      dir=str(tmp_path / "port"))
    wd.begin_run(backend="fused")
    wd.on_step(_sample(3, residual=1.0))
    rwd = robs.Watchdog([robs.residual(tol=1e-9, warmup=0)],
                        dir=str(tmp_path / "ref"))
    rwd.begin_run(backend="numpy")
    rwd.on_step(_sample(3, residual=1.0))
    port_path, ref_path = wd.fired[0][1], rwd.fired[0][1]
    assert robs.load_bundle(port_path)["reason"] == \
        obs.load_bundle(ref_path)["reason"]
    assert "postmortem: residual" in ref_report.html_report(
        bundles=[robs.load_bundle(port_path)])
    assert "postmortem: residual" in obs_report.html_report(
        bundles=[obs.load_bundle(ref_path)])
    with obs.session(mode="trace") as sess:
        with obs.span("sim.run"):
            pass
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps(sess.snapshot()))
    out = tmp_path / "r.html"
    assert ref_report.main(["-o", str(out), "--session", str(snap)]) == 0
    assert "sim.run" in out.read_text()
    path = str(tmp_path / "stream.jsonl")
    with obs.ObsStreamer(path) as st:
        st.emit("x", v=1)
    with robs.ObsStreamer(str(tmp_path / "ref.jsonl")) as st:
        st.emit("x", v=1)
    heads = [json.loads(open(p).readline())["schema"]
             for p in (path, str(tmp_path / "ref.jsonl"))]
    assert heads[0] == heads[1] == "repro.obs/stream/1"


# -- thread-safe metrics ----------------------------------------------------


def test_counter_exact_under_4_workers():
    n_workers, n_inc = 4, 25_000
    with obs.session(mode="metrics") as sess:
        c = sess.metrics.counter("stress.total")
        h = sess.metrics.histogram("stress.obs")
        s = sess.metrics.series("stress.series")

        def work():
            for _ in range(n_inc):
                c.add(1.0)
                h.observe(1.0)
                s.append(1.0)

        threads = [threading.Thread(target=work) for _ in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    # lost updates would show as a short count; the locks make it exact
    assert c.value == float(n_workers * n_inc)
    assert len(h.values) == n_workers * n_inc
    snap = sess.metrics.snapshot()
    assert snap["stress.total"]["value"] == float(n_workers * n_inc)
    assert snap["stress.series"]["count"] == n_workers * n_inc


# -- streaming export -------------------------------------------------------


def test_streamer_header_events_and_emit(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    with obs.session(mode="metrics", stream=path) as sess:
        assert sess.stream is not None
        obs.emit("checkpoint", phase="one", value=1.5)
        obs.emit("checkpoint", phase="two", arr=np.float64(2.0))
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["schema"] == "repro.obs/stream/1"
    assert lines[1]["kind"] == "checkpoint" and lines[1]["phase"] == "one"
    assert lines[2]["arr"] == 2.0
    assert all("t_s" in ln for ln in lines[1:])
    # emit without a session (or without a stream) is a silent no-op
    obs.emit("nobody", listening=True)
    with obs.session(mode="metrics"):
        obs.emit("nobody", listening=True)


def test_progress_emits_done_total_eta(tmp_path):
    path = str(tmp_path / "prog.jsonl")
    with obs.session(mode="metrics", stream=path) as sess:
        p = obs.Progress("adversary.candidates", total=4)
        for i in range(4):
            p.step(pattern=f"p{i}")
        snap = sess.metrics.snapshot()
    assert snap["adversary.candidates.done"]["value"] == 4.0
    events = [json.loads(ln) for ln in open(path)][1:]
    assert [e["done"] for e in events] == [1, 2, 3, 4]
    assert all(e["kind"] == "progress" and e["total"] == 4 for e in events)
    assert events[0]["pct"] == 25.0 and "eta_s" in events[0]
    assert events[-1]["pct"] == 100.0 and "eta_s" not in events[-1]


def test_openmetrics_text_format():
    reg = obs.MetricsRegistry()
    reg.counter("sim.delivered").add(12.5)
    reg.gauge("sim.backend[fused]").set(1.0)
    reg.histogram("sim.link_util").observe_many([0.1, 0.5, 0.9])
    reg.series("sim.occ_vc0").append(3.0)
    text = obs.openmetrics_text(reg)
    assert "# TYPE repro_sim_delivered counter" in text
    assert "repro_sim_delivered_total 12.5" in text
    assert 'repro_sim_backend{variant="fused"} 1.0' in text
    assert "# TYPE repro_sim_link_util summary" in text
    assert 'repro_sim_link_util{quantile="0.5"}' in text
    assert "repro_sim_link_util_count 3" in text
    assert text.endswith("# EOF\n")
    # snapshot dicts and sessions render identically
    assert obs.openmetrics_text(reg.snapshot()) == text
    # and as the reference renders the same snapshot
    assert robs.openmetrics_text(reg.snapshot()) == text


def test_write_openmetrics(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("a.b").add(1.0)
    out = tmp_path / "metrics.prom"
    obs.write_openmetrics(str(out), reg)
    assert out.read_text().endswith("# EOF\n")


# -- HTML report ------------------------------------------------------------


def _bench_payload(seconds, err, with_error=False):
    return {"schema_version": 2, "total_seconds": seconds,
            "entries": [{"name": "sim[pn16:ugal]", "seconds": seconds,
                         "max_rel_err": err}],
            "errors": ([{"section": "sim", "error": "Boom"}]
                       if with_error else [])}


def test_html_report_bench_session_bundle(tmp_path):
    for i, (s, e) in enumerate([(1.0, 0.01), (1.2, 0.02), (0.9, 0.015)]):
        (tmp_path / f"BENCH_{i}.json").write_text(
            json.dumps(_bench_payload(s, e, with_error=(i == 2))))
    with obs.session(mode="trace") as sess:
        with obs.span("sim.run", offered=1.0):
            sess.metrics.gauge("sim.balance.gini").set(0.12)
            sess.metrics.series("sim.occ_vc0").append(1.0)
            sess.metrics.series("sim.occ_vc0").append(2.0)
    wd = obs.Watchdog([obs.residual(tol=1e-9, warmup=0)],
                      dir=str(tmp_path / "pm"))
    wd.begin_run(backend="dense")
    wd.on_step(_sample(3, residual=1.0))
    bundle = obs.load_bundle(wd.fired[0][1])

    doc = obs_report.html_report(
        bench_dir=str(tmp_path),
        sessions=[("probe", sess.snapshot(),
                   obs_report.session_series(sess))],
        bundles=[bundle], title="test report")
    assert doc.startswith("<!DOCTYPE html>") and doc.endswith("</html>")
    assert "BENCH trajectory (3 files)" in doc
    assert "sim[pn16:ugal]" in doc and "<svg" in doc
    assert "crashed sections in BENCH_2.json" in doc       # banner
    assert "session: probe" in doc and "sim.balance.gini" in doc
    assert "sim.run" in doc
    assert "postmortem: residual" in doc
    assert "conservation residual" in doc                  # the reason
    # no external references: self-contained single file
    assert "http" not in doc.replace("http://www.w3.org", "")


def test_report_cli_and_error_paths(tmp_path, capsys):
    out = tmp_path / "r.html"
    (tmp_path / "BENCH_0.json").write_text(
        json.dumps(_bench_payload(1.0, 0.01)))
    rc = obs_report.main(["-o", str(out), "--bench-dir", str(tmp_path)])
    assert rc == 0 and out.exists()
    assert "<h1>" in out.read_text()
    # a --session file that is neither a snapshot nor a BENCH payload
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": 1}))
    rc = obs_report.main(["-o", str(out), "--session", str(bad)])
    assert rc == 2
    # a BENCH payload with an obs block loads per-section sessions
    payload = _bench_payload(1.0, 0.01)
    payload["obs"] = {"sim": {"schema": "repro.obs/1", "mode": "trace",
                              "spans": {}, "metrics": {}}}
    snap = tmp_path / "BENCH_obs.json"
    snap.write_text(json.dumps(payload))
    rc = obs_report.main(["-o", str(out), "--session", str(snap)])
    assert rc == 0 and "BENCH_obs.json:sim" in out.read_text()
