"""The port's arc-load engines (repro_torch.core.utilization) against the
reference's (repro.core.utilization), on the CPU in float64.

The port's ``dense`` engine (torch.matmul + masks, the reference's
``jax`` engine) and ``fused`` engine (the mask+GEMM kernels' plain
versions on CPU tensors, the reference's ``pallas``) are held against
the reference's ``naive`` (per-source Brandes), ``numpy`` (batched GEMMs)
and ``pallas`` (the Pallas kernels under the interpreter, float64)
engines on identical graphs: loads at rtol/atol 1e-9 (different
summation orders), kbar and diameter exactly.  Never against the
reference's ``jax``/``auto`` on pn16-sized graphs (its float64 switch is
dead on the installed jax).
"""

from __future__ import annotations

import functools
import importlib

import numpy as np
import pytest
import torch

from repro.core import hypercube_graph, oft_graph, pn_graph
from repro.core.graph import Graph as RefGraph
from repro.core.utilization import arc_loads as ref_arc_loads
from repro.core.utilization import arc_loads_weighted as ref_weighted
from repro.core.utilization import utilization as ref_utilization
from repro.core.utilization import valiant_report as ref_valiant
from repro_torch.convert import graph_from_arrays
from repro_torch.core import (Graph, arc_loads, arc_loads_weighted,
                              utilization, valiant_report)
from repro_torch.core.projective import pn_graph as port_pn_graph

# the module (the package attribute of that name is the function)
U = importlib.import_module("repro_torch.core.utilization")

GRAPHS = {"pn3": lambda: pn_graph(3), "pn5": lambda: pn_graph(5),
          "hypercube4": lambda: hypercube_graph(4),
          "oft4": lambda: oft_graph(4)}
PORT_ENGINES = ["dense", "fused"]


@functools.cache
def _graphs(name):
    g = GRAPHS[name]()
    return g, graph_from_arrays(g.n, g.edges, g.meta, name=g.name)


@functools.cache
def _ref(name, engine):
    g, _ = _graphs(name)
    return ref_arc_loads(g, targets_mask=g.meta.get("leaf_mask"),
                         engine=engine)


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
    assert got[1] == want[1]
    assert got[2] == want[2]


@pytest.mark.parametrize("ref_engine", ["naive", "numpy", "pallas"])
@pytest.mark.parametrize("engine", PORT_ENGINES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_engines_match_reference(name, engine, ref_engine):
    g, gp = _graphs(name)
    got = arc_loads(gp, targets_mask=gp.meta.get("leaf_mask"),
                    engine=engine, device="cpu")
    _assert_same(got, _ref(name, ref_engine))


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_pn_uniform_closed_form(engine):
    """PN is arc-transitive: u = 1, and from any point its q + 1 lines
    lie at 1 hop, the other points at 2 and the remaining lines at 3."""
    g = port_pn_graph(5)
    rep = utilization(g, engine=engine, device="cpu")
    q = 5
    npts = q * q + q + 1
    kbar = ((q + 1) + 2 * (npts - 1) + 3 * (npts - q - 1)) / (g.n - 1)
    assert rep.u == pytest.approx(1.0, abs=1e-12)
    assert rep.kbar == pytest.approx(kbar, rel=1e-15)
    assert rep.diameter == 3
    assert rep.loads.sum() == pytest.approx(kbar * g.n * (g.n - 1),
                                            rel=1e-12)


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_oft_leaf_restricted(engine):
    """Section 6: OFT traffic restricted to its leaves (the leaf mask
    comes from meta) gives u = 1 and kbar = 2."""
    _, gp = _graphs("oft4")
    rep = utilization(gp, engine=engine, device="cpu")
    ref = ref_utilization(_graphs("oft4")[0], engine="naive")
    assert rep.u == pytest.approx(1.0, abs=1e-10)
    assert rep.kbar == 2.0 and rep.diameter == 2
    np.testing.assert_allclose(rep.loads, ref.loads, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_disconnected_graph_raises(engine):
    g = Graph(4, np.array([[0, 1], [2, 3]]))
    with pytest.raises(ValueError, match="disconnected"):
        arc_loads(g, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="disconnected"):
        arc_loads_weighted(g, np.ones((4, 4)), engine=engine, device="cpu")


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_trailing_isolated_vertex(engine):
    """A degree-0 vertex with the highest index has an empty CSR row;
    it is unreachable and the graph is disconnected."""
    g = Graph(4, np.array([[0, 1], [1, 2]]))
    with pytest.raises(ValueError, match="disconnected"):
        arc_loads(g, engine=engine, device="cpu")
    # restricted to the connected part's sources, the isolated vertex is
    # still a target, so the sweep still raises
    with pytest.raises(ValueError, match="disconnected"):
        arc_loads(g, sources=[0], engine=engine, device="cpu")


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_explicit_sources_subset(engine):
    g, gp = _graphs("pn5")
    srcs = np.array([0, 3, 17, 40])
    want = ref_arc_loads(g, sources=srcs, engine="naive")
    got = arc_loads(gp, sources=srcs, engine=engine, device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_source_blocks_add_up(engine, monkeypatch):
    """Several source blocks (as at PN(64), 12 blocks of 756 rows) give
    the loads of one block."""
    _, gp = _graphs("hypercube4")
    one = arc_loads(gp, engine=engine, device="cpu")
    monkeypatch.setattr(U, "_source_block_rows", lambda n: 5)
    got = arc_loads(gp, engine=engine, device="cpu")
    np.testing.assert_allclose(got[0], one[0], rtol=1e-12, atol=1e-12)
    assert got[1:] == one[1:]


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_arc_sum_chunks_add_up(engine, monkeypatch):
    _, gp = _graphs("pn5")
    one = arc_loads(gp, engine=engine, device="cpu")
    monkeypatch.setattr(U, "_ARC_CHUNK_BYTES", 8 * 62 * 7)  # 7-arc chunks
    got = arc_loads(gp, engine=engine, device="cpu")
    # torch may vectorize a column sum differently at another width
    np.testing.assert_allclose(got[0], one[0], rtol=1e-13, atol=0)


@pytest.mark.parametrize("engine", PORT_ENGINES)
@pytest.mark.parametrize("name", ["pn5", "hypercube4"])
def test_weighted_matches_reference(name, engine):
    """A random sparse demand matrix against the reference's naive and
    numpy weighted sweeps; kbar is a weighted float sum, so it agrees to
    round-off (rel 1e-12), the diameter exactly."""
    g, gp = _graphs(name)
    rng = np.random.default_rng(7)
    dem = rng.random((g.n, g.n)) * (rng.random((g.n, g.n)) < 0.2)
    got = arc_loads_weighted(gp, dem, engine=engine, device="cpu")
    for ref_engine in ("naive", "numpy"):
        want = ref_weighted(g, dem, engine=ref_engine)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
        assert got[1] == pytest.approx(want[1], rel=1e-12)
        assert got[2] == want[2]


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_weighted_uniform_reproduces_arc_loads(engine):
    _, gp = _graphs("pn5")
    n = gp.n
    uni = arc_loads(gp, engine=engine, device="cpu")
    got = arc_loads_weighted(gp, np.ones((n, n)) - np.eye(n),
                             engine=engine, device="cpu")
    np.testing.assert_allclose(got[0], uni[0], rtol=1e-12, atol=1e-12)
    assert got[1] == pytest.approx(uni[1], rel=1e-14)
    assert got[2] == uni[2]


def test_weighted_validation():
    _, gp = _graphs("pn3")
    n = gp.n
    for bad, match in ((np.ones((3, 3)), "demand must be"),
                       (np.full((n, n), np.nan), "finite"),
                       (-np.ones((n, n)), "nonnegative"),
                       (np.eye(n), "all zero")):
        with pytest.raises(ValueError, match=match):
            arc_loads_weighted(gp, bad, device="cpu")


def test_valiant_report_matches_reference():
    g, gp = _graphs("pn5")
    want = ref_valiant(g)
    got = valiant_report(gp, engine="fused", device="cpu")
    np.testing.assert_allclose(got.loads, want.loads, rtol=1e-9, atol=1e-9)
    assert got.kbar == want.kbar and got.diameter == want.diameter
    assert got.u == pytest.approx(want.u, rel=1e-12)


def test_engine_names():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert U.resolve_engine("auto", cpu) == "dense"
    assert U.resolve_engine(None, cpu) == "dense"
    assert U.resolve_engine("auto", cuda) == "fused"
    assert U.resolve_engine("FUSED", cpu) == "fused"
    for eng in ("naive", "numpy", "csr"):
        with pytest.raises(ValueError, match="ROADMAP"):
            U.resolve_engine(eng, cpu)
    # the orbit shortcut sits above the exact engine that runs its sweeps
    assert U.resolve_engine("orbit", cpu) == "dense"
    assert U.resolve_engine("orbit", cuda) == "fused"
    with pytest.raises(ValueError, match="'dense'"):
        U.resolve_engine("jax", cpu)
    with pytest.raises(ValueError, match="'fused'"):
        U.resolve_engine("pallas", cpu)
    with pytest.raises(ValueError, match="unknown engine"):
        arc_loads(_graphs("pn3")[1], engine="bogus", device="cpu")


def test_reference_graph_type_round_trips():
    """convert.graph_from_arrays keeps the arc order, so per-arc loads
    line up index by index with the reference's."""
    g, gp = _graphs("oft4")
    assert isinstance(g, RefGraph)
    np.testing.assert_array_equal(gp.arc_src, g.arc_src)
    np.testing.assert_array_equal(gp.indices, g.indices)
