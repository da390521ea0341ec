"""repro_torch.core.orbits and the orbit shortcut of the port's arc-load
engines against repro.core, on the CPU.

``orbit_info`` of every family with known generators must equal the
reference's array for array, with and without a preserve mask (both
packages build the same edge arrays, so arcs and vertices line up).  The
``orbit`` engine and ``auto`` (which takes the shortcut with default
sources) lie within rtol 1e-9 of the reference's ``orbit`` and ``numpy``
engines, kbar and diameter exactly; ``orbit`` raises where a family has
no generators; a uniform-shaped weighted demand goes through the orbit
path (a spy on ``_loads_orbit``), anything else through the exact
engine.
"""

from __future__ import annotations

import functools
import importlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.orbits import orbit_info as ref_orbit_info
from repro.core.utilization import arc_loads as ref_arc_loads
from repro.core.utilization import arc_loads_weighted as ref_weighted
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
from repro_torch.fabric import torus3d_graph

U = importlib.import_module("repro_torch.core.utilization")

# (name, graph constructor on a package)
FAMILIES = [
    ("pn4", lambda m: m.pn_graph(4)),
    ("pn5", lambda m: m.pn_graph(5)),
    ("demi_pn4", lambda m: m.demi_pn_graph(4)),
    ("demi_pn5", lambda m: m.demi_pn_graph(5)),
    ("oft3", lambda m: m.oft_graph(3)),
    ("oft4", lambda m: m.oft_graph(4)),
    ("mlfm4", lambda m: m.mlfm_graph(4)),
    ("mms5", lambda m: m.mms_graph(5)),
    ("mms4", lambda m: m.mms_graph(4)),
    ("hamming4x2", lambda m: m.hamming_graph(4, 2)),
    ("hamming3x3", lambda m: m.hamming_graph(3, 3)),
    ("hypercube4", lambda m: m.hypercube_graph(4)),
    ("complete6", lambda m: m.complete_graph(6)),
    ("bipartite5", lambda m: m.complete_bipartite_graph(5)),
    ("paley13", lambda m: m.paley_graph(13)),
    ("paley9", lambda m: m.paley_graph(9)),
]
NAMES = [name for name, _ in FAMILIES]
NO_GENERATORS = [
    ("dragonfly2", lambda m: m.dragonfly_graph(2)),
    ("turan9", lambda m: m.turan_graph(9, 3)),
    ("random16", lambda m: m.random_regular_graph(16, 4, seed=1)),
]


@pytest.fixture(autouse=True)
def _one_thread():
    # torch on this box is slow multithreaded at tiny sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _pair(name):
    build = dict(FAMILIES + NO_GENERATORS)[name]
    return build(P), build(R)


def _mask(name, g):
    """A preserve mask for each family: the leaf mask of an indirect
    network, else the first half of the vertices (PN: the points)."""
    leaf = g.meta.get("leaf_mask")
    if leaf is not None:
        return np.asarray(leaf, dtype=bool)
    mask = np.zeros(g.n, dtype=bool)
    mask[: g.n // 2] = True
    return mask


def _same_info(got, want):
    if want is None:
        assert got is None
        return
    for key in ("vertex_orbit", "vertex_reps", "vertex_sizes", "arc_orbit",
                "arc_sizes"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.n_vertex_orbits == want.n_vertex_orbits


@pytest.mark.parametrize("name", NAMES)
def test_orbit_info_equals_reference(name):
    gp, gr = _pair(name)
    np.testing.assert_array_equal(gp.edges, gr.edges)
    gens_p = P.automorphism_generators(gp)
    gens_r = R.automorphism_generators(gr)
    assert len(gens_p) == len(gens_r)
    for a, b in zip(gens_p, gens_r):
        np.testing.assert_array_equal(a, b)
    _same_info(P.orbit_info(gp), ref_orbit_info(gr))


@pytest.mark.parametrize("name", NAMES)
def test_orbit_info_with_preserve_mask_equals_reference(name):
    gp, gr = _pair(name)
    mask = _mask(name, gr)
    _same_info(P.orbit_info(gp, mask.copy()), ref_orbit_info(gr, mask))


def test_orbit_info_is_cached_per_mask():
    gp, _ = _pair("oft4")
    leaf = gp.meta["leaf_mask"]
    a, b = P.orbit_info(gp), P.orbit_info(gp, leaf)
    assert P.orbit_info(gp) is a and P.orbit_info(gp, leaf.copy()) is b
    assert a.n_vertex_orbits == 2 and b.n_vertex_orbits == 2
    assert not hasattr(gp, "_orbit_cache")
    assert ("orbits", None) in gp._struct_cache


@pytest.mark.parametrize("name", [n for n, _ in NO_GENERATORS])
def test_no_generators_equal_reference_and_orbit_raises(name):
    gp, gr = _pair(name)
    assert P.automorphism_generators(gp) is None
    assert R.automorphism_generators(gr) is None
    assert P.orbit_info(gp) is None
    with pytest.raises(ValueError, match="no known automorphism generators"):
        P.arc_loads(gp, engine="orbit", device="cpu")
    # auto falls back to the exact engine
    got = P.arc_loads(gp, engine="auto", device="cpu")
    want = ref_arc_loads(gr, engine="numpy")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
    assert got[1:] == want[1:]


def test_torus_has_no_generators():
    gp, gr = torus3d_graph(4, 4, 1), ref_torus3d_graph(4, 4, 1)
    assert P.automorphism_generators(gp) is None
    assert R.automorphism_generators(gr) is None


@functools.cache
def _ref_loads(name, engine, masked):
    _, gr = _pair(name)
    tm = gr.meta.get("leaf_mask") if masked else None
    return ref_arc_loads(gr, targets_mask=tm, engine=engine)


@pytest.mark.parametrize("engine", ["orbit", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_orbit_loads_match_reference(name, engine):
    gp, _ = _pair(name)
    masked = gp.meta.get("leaf_mask") is not None
    tm = gp.meta.get("leaf_mask") if masked else None
    got = P.arc_loads(gp, targets_mask=tm, engine=engine, device="cpu")
    for ref_engine in ("orbit", "numpy"):
        want = _ref_loads(name, ref_engine, masked)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
        assert got[1] == want[1]
        assert got[2] == want[2]


def test_orbit_path_runs_one_sweep_per_vertex_orbit(monkeypatch):
    """PN is vertex-transitive: one sweep from one source, on the exact
    engine; explicit sources skip the shortcut under auto."""
    gp, _ = _pair("pn5")
    calls = []
    real = U._loads

    def spy(g, sources, targets_mask, demand, engine, device):
        calls.append((len(sources), engine))
        return real(g, sources, targets_mask, demand, engine, device)

    monkeypatch.setattr(U, "_loads", spy)
    P.utilization(gp, device="cpu")
    assert calls == [(1, "dense")]
    calls.clear()
    P.utilization(gp, engine="orbit", device="cpu")
    assert calls == [(1, "dense")]
    calls.clear()
    P.arc_loads(gp, sources=np.arange(gp.n), device="cpu")
    assert calls == [(gp.n, "dense")]
    calls.clear()
    with pytest.raises(ValueError, match="no known automorphism"):
        P.arc_loads(gp, sources=np.arange(gp.n), engine="orbit",
                    device="cpu")
    calls.clear()
    P.utilization(gp, engine="fused", device="cpu")
    assert calls == [(gp.n, "fused")]


def test_engine_resolution_below_the_shortcut():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert U.resolve_engine("orbit", cpu) == "dense"
    assert U.resolve_engine("orbit", cuda) == "fused"
    assert U.resolve_engine("auto", cuda) == "fused"
    assert U.ENGINES == ("auto", "dense", "fused", "orbit")


def _spy_orbit(monkeypatch):
    calls = []
    real = U._loads_orbit

    def spy(g, targets_mask, engine, device):
        res = real(g, targets_mask, engine, device)
        calls.append(res is not None)
        return res

    monkeypatch.setattr(U, "_loads_orbit", spy)
    return calls


@pytest.mark.parametrize("engine", ["auto", "orbit"])
def test_weighted_uniform_split_takes_orbit_path(monkeypatch, engine):
    gp, gr = _pair("oft4")
    calls = _spy_orbit(monkeypatch)
    leaf = gp.meta["leaf_mask"]
    dem = np.zeros((gp.n, gp.n))
    dem[np.ix_(leaf, leaf)] = 0.25
    np.fill_diagonal(dem, 0.0)
    got = P.arc_loads_weighted(gp, dem, engine=engine, device="cpu")
    assert calls == [True]
    for ref_engine in ("orbit", "numpy"):
        want = ref_weighted(gr, dem, engine=ref_engine)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
        assert got[1] == pytest.approx(want[1], rel=1e-12)
        assert got[2] == want[2]


def test_weighted_nonuniform_runs_exact_engine(monkeypatch):
    gp, gr = _pair("pn5")
    calls = _spy_orbit(monkeypatch)
    dem = np.random.default_rng(0).random((gp.n, gp.n))
    got = P.arc_loads_weighted(gp, dem, engine="auto", device="cpu")
    assert calls == []
    want = ref_weighted(gr, dem, engine="numpy")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
    assert got[1] == pytest.approx(want[1], rel=1e-12)


def test_weighted_orbit_without_generators_runs_exact(monkeypatch):
    """engine="orbit" on a weighted uniform demand keeps the weighted
    path's contract where there are no generators: the exact engine
    runs instead of raising."""
    gp, gr = _pair("dragonfly2")
    calls = _spy_orbit(monkeypatch)
    dem = 2.0 * (np.ones((gp.n, gp.n)) - np.eye(gp.n))
    got = P.arc_loads_weighted(gp, dem, engine="orbit", device="cpu")
    assert calls == [False]
    want = ref_weighted(gr, dem, engine="numpy")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)


def test_saturation_report_auto_matches_fused():
    """The routing models on the shortcut agree with the all-source
    sweep: uniform and a tornado under ugal."""
    gp, _ = _pair("pn5")
    for pattern in ("uniform", "tornado"):
        a = P.saturation_report(gp, pattern, routing="ugal", device="cpu")
        b = P.saturation_report(gp, pattern, routing="ugal",
                                engine="fused", device="cpu")
        assert a.theta == pytest.approx(b.theta, rel=1e-9)
        np.testing.assert_allclose(a.loads, b.loads, rtol=1e-9, atol=1e-9)
