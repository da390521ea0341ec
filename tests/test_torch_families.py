"""repro_torch's topology families against the reference's, on the CPU.

Every constructor of the port (``core/projective.py``, ``core/mms.py``,
``core/reference.py``, ``core/registry.py``, ``fabric/model.py``) must
build the reference's graph exactly: the same edge array in the same
order (hence the same CSR and arc order) and the same ``meta``.  The
Moore bounds, the host BFS, the distance distribution, the cached
structure of ``Graph`` and the Baer-subplane partition are held to the
reference exactly too (integer arithmetic, or float64 sums of integers).
The structure checks of ``tests/test_projective.py`` are repeated on the
port's own graphs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import moore as ref_moore
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
import repro_torch.core as P
from repro_torch.core import moore
from repro_torch.core.graph import adjacency_dense
from repro_torch.fabric import torus3d_graph

QS = [2, 3, 4, 5, 7, 8, 9]

# arguments for every registry name (the reference's own constructors
# take the same ones)
REGISTRY_ARGS = {
    "pn": (3,), "demi_pn": (4,), "oft": (3,), "mlfm": (4,), "mms": (5,),
    "slimfly": (7,), "complete": (6,), "turan": (7, 3), "bipartite": (4,),
    "paley": (13,), "hamming": (4,), "dragonfly": (2,), "hypercube": (4,),
    "random": (20, 3),
}


def _same_graph(got, want):
    assert got.n == want.n and got.name == want.name
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.arc_edge_id, want.arc_edge_id)
    assert set(got.meta) == set(want.meta)
    for key, val in want.meta.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(got.meta[key], val, err_msg=key)
        else:
            assert got.meta[key] == val, key


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("family", ["pn_graph", "demi_pn_graph",
                                    "oft_graph"])
def test_projective_families_match_reference(family, q):
    _same_graph(getattr(P, family)(q), getattr(R, family)(q))


@pytest.mark.parametrize("make,args", [
    ("mlfm_graph", (4,)), ("mlfm_graph", (6,)),
    ("mms_graph", (5,)), ("mms_graph", (7,)),
    ("complete_graph", (6,)), ("turan_graph", (7, 3)),
    ("complete_bipartite_graph", (4,)), ("paley_graph", (13,)),
    ("hamming_graph", (4,)), ("hamming_graph", (3, 3)),
    ("dragonfly_graph", (2,)), ("dragonfly_graph", (3,)),
    ("hypercube_graph", (4,)),
    ("random_regular_graph", (20, 3, 0)),
    ("random_regular_graph", (20, 3, 1)),
])
def test_other_families_match_reference(make, args):
    _same_graph(getattr(P, make)(*args), getattr(R, make)(*args))


@pytest.mark.parametrize("dims", [(4, 4, 1), (3, 4, 5), (2, 3, 4)])
def test_torus3d_matches_reference(dims):
    _same_graph(torus3d_graph(*dims), ref_torus3d_graph(*dims))


@pytest.mark.parametrize("name", sorted(REGISTRY_ARGS))
def test_build_topology_matches_reference(name):
    assert set(P.TOPOLOGIES) == set(R.TOPOLOGIES) == set(REGISTRY_ARGS)
    args = REGISTRY_ARGS[name]
    _same_graph(P.build_topology(name, *args),
                R.build_topology(name, *args))


def test_registry_rejects_unknown_names_and_bad_parameters():
    with pytest.raises(KeyError, match="unknown topology"):
        P.build_topology("butterfly", 4)
    with pytest.raises(ValueError, match="prime power"):
        P.pn_graph(6)
    with pytest.raises(ValueError, match="mod 4"):
        P.paley_graph(7)
    with pytest.raises(ValueError, match="no MMS"):
        P.mms_graph(2)
    with pytest.raises(ValueError, match="even"):
        P.random_regular_graph(5, 3)


def test_small_helpers_match_reference():
    for q in (3, 4, 5, 7, 8, 9):
        x0, x1, eps = P.mms_generator_sets(q)
        w0, w1, weps = R.mms.mms_generator_sets(q)
        np.testing.assert_array_equal(x0, w0)
        np.testing.assert_array_equal(x1, w1)
        assert eps == weps == P.mms_eps(q)
        np.testing.assert_array_equal(P.self_orthogonal_points(q),
                                      R.self_orthogonal_points(q))
    for h in (2, 3, 7):
        assert P.dragonfly_canonical_stats(h) == \
            R.reference.dragonfly_canonical_stats(h)


def test_moore_functions_match_reference():
    for delta, k in [(3, 2), (4, 3), (17, 2), (2, 5)]:
        assert moore.moore_bound(delta, k) == ref_moore.moore_bound(delta, k)
        np.testing.assert_array_equal(
            moore.moore_distance_distribution(delta, k),
            ref_moore.moore_distance_distribution(delta, k))
    for delta, k, n in [(3, 2, 8), (17, 2, 546), (17, 3, 546), (10, 3, 200)]:
        if n > ref_moore.moore_bound(delta, k) or (
                k >= 1 and n <= ref_moore.moore_bound(delta, k - 1)):
            with pytest.raises(ValueError):
                moore.generalized_moore_distribution(delta, k, n)
            continue
        np.testing.assert_array_equal(
            moore.generalized_moore_distribution(delta, k, n),
            ref_moore.generalized_moore_distribution(delta, k, n))
        assert moore.generalized_moore_kbar(delta, k, n) == \
            ref_moore.generalized_moore_kbar(delta, k, n)
        assert moore.kbar_approx(delta, k, n) == \
            ref_moore.kbar_approx(delta, k, n)
    for delta, n in [(3, 14), (17, 546), (65, 8322)]:
        assert moore.min_kbar(delta, n) == ref_moore.min_kbar(delta, n)
    assert moore.terminals_bound(64, 3, 2.5) == \
        ref_moore.terminals_bound(64, 3, 2.5)
    with pytest.raises(ValueError, match="k̄"):
        moore.terminals_bound(64, 3, 3.0)


@pytest.mark.parametrize("make", [
    lambda m: m.pn_graph(5), lambda m: m.demi_pn_graph(4),
    lambda m: m.oft_graph(3), lambda m: m.dragonfly_graph(2),
    lambda m: m.hypercube_graph(4)])
def test_distances_and_structure_match_reference(make):
    got, want = make(P), make(R)
    for v in (0, 1, want.n // 2, want.n - 1):
        np.testing.assert_array_equal(P.bfs_distances(got, v),
                                      R.bfs_distances(want, v))
        np.testing.assert_array_equal(got.distances_from(v),
                                      want.distances_from(v))
    np.testing.assert_array_equal(
        P.distance_distribution(got, device="cpu"),
        R.distance_distribution(want))
    np.testing.assert_array_equal(
        got.distance_distribution([0, 3], device="cpu"),
        want.distance_distribution([0, 3]))
    assert got.diameter(device="cpu") == want.diameter()
    assert got.average_distance(device="cpu") == want.average_distance()
    assert got.is_connected() == want.is_connected()
    assert got.is_regular() == want.is_regular()
    bip_got, bip_want = got.bipartition(), want.bipartition()
    assert (bip_got is None) == (bip_want is None)
    if bip_want is not None:
        np.testing.assert_array_equal(bip_got, bip_want)
    for method in ("reverse_arcs", "arcs_by_dst"):
        np.testing.assert_array_equal(getattr(got, method)(),
                                      getattr(want, method)())
    for a, b in zip(got.arc_sort_by_pair(), want.arc_sort_by_pair()):
        np.testing.assert_array_equal(a, b)
    # derived graphs: an edge mask, and a vertex mask with relabelling
    rng = np.random.default_rng(0)
    em = rng.random(want.num_edges) < 0.8
    vm = rng.random(want.n) < 0.9
    for kw in ({"edge_mask": em}, {"edge_mask": em, "vertex_mask": vm},
               {"vertex_mask": vm}):
        _same_graph(got.subgraph(**kw, name="sub", meta={"x": 1}),
                    want.subgraph(**kw, name="sub", meta={"x": 1}))


def test_distance_distribution_rejects_disconnected_graphs():
    g = P.Graph(6, np.array([[0, 1], [1, 2], [3, 4], [4, 5]]))
    assert not g.is_connected()
    assert g.bipartition() is not None
    with pytest.raises(ValueError, match="disconnected"):
        P.distance_distribution(g, device="cpu")


@pytest.mark.parametrize("q", [4, 9])
def test_subplane_classes_match_reference(q):
    cls = P.subplane_classes(q)
    np.testing.assert_array_equal(cls, R.subplane_classes(q))
    np.testing.assert_array_equal(P.subplane_line_classes(q, cls),
                                  R.subplane_line_classes(q, cls))
    with pytest.raises(ValueError, match="not a square"):
        P.subplane_classes(8)


# ---------------------------------------------------------------------------
# The structure checks of tests/test_projective.py on the port's graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", QS)
def test_pn_structure(q):
    g = P.pn_graph(q)
    n = P.num_points(q)
    assert g.n == 2 * n
    assert g.is_regular() and g.max_degree == q + 1
    assert ((g.edges[:, 0] < n) != (g.edges[:, 1] < n)).all()
    w = g.distance_distribution([0, n], device="cpu")
    assert np.allclose(w, [1, q + 1, q * q + q, q * q])
    kbar = g.average_distance([0], device="cpu")
    assert abs(kbar - (5 * q * q + 3 * q + 1) / (2 * q * q + 2 * q + 1)) \
        < 1e-12


@pytest.mark.parametrize("q", QS)
def test_demi_pn_structure(q):
    g = P.demi_pn_graph(q)
    n = P.num_points(q)
    assert g.n == n
    assert g.num_edges == q * (q + 1) ** 2 // 2
    so = P.self_orthogonal_points(q)
    assert len(so) == q + 1
    deg = g.degrees
    assert (deg[so] == q).all()
    mask = np.ones(n, dtype=bool)
    mask[so] = False
    assert (deg[mask] == q + 1).all()
    assert g.diameter(device="cpu") == 2
    # Lemma 3.8: no 4-cycles, so distance-2 pairs share one neighbour
    a = adjacency_dense(g, torch.int64, "cpu").numpy()
    a2 = a @ a
    nonadj = (a == 0) & ~np.eye(n, dtype=bool)
    assert (a2[nonadj] == 1).all()


@pytest.mark.parametrize("q", [2, 3, 4, 5])
def test_oft_structure(q):
    g = P.oft_graph(q)
    n = P.num_points(q)
    assert g.n == 3 * n
    deg = g.degrees
    assert (deg[:n] == q + 1).all() and (deg[2 * n:] == q + 1).all()
    assert (deg[n: 2 * n] == 2 * (q + 1)).all()
    leaf = g.meta["leaf_mask"]
    for v in [0, 1, 2 * n, 3 * n - 1]:
        assert g.distances_from(v)[leaf].max() == 2


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_mlfm_structure(n):
    g = P.mlfm_graph(n)
    n_leaves = n * (n - 1)
    assert g.n == n_leaves + n * (n - 1) // 2
    deg = g.degrees
    assert (deg[:n_leaves] == n - 1).all()
    assert (deg[n_leaves:] == 2 * (n - 1)).all()
    leaf = g.meta["leaf_mask"]
    for v in range(0, n_leaves, max(1, n_leaves // 4)):
        assert g.distances_from(v)[leaf].max() == 2


@pytest.mark.parametrize("q", [4, 9])
def test_subplane_partition(q):
    p = int(round(q ** 0.5))
    cls = P.subplane_classes(q)
    r = p * p - p + 1
    assert len(np.unique(cls)) == r
    assert (np.bincount(cls) == p * p + p + 1).all()
    lcls = P.subplane_line_classes(q, cls)
    g = P.pn_graph(q)
    lbl = np.concatenate([cls, lcls])
    same = lbl[g.edges[:, 0]] == lbl[g.edges[:, 1]]
    per = np.bincount(lbl[g.edges[:, 0]][same], minlength=r)
    assert (per == (p * p + p + 1) * (p + 1)).all()


def test_torus_and_dragonfly_structure():
    g = torus3d_graph(8, 16, 1)
    assert g.n == 128 and g.is_regular() and g.max_degree == 4
    assert g.diameter([0], device="cpu") == 4 + 8
    g = torus3d_graph(16, 16, 16)
    assert (g.n, g.num_edges) == (4096, 3 * 4096)
    assert g.diameter([0], device="cpu") == 24
    d = P.dragonfly_graph(3)
    assert (d.n, d.meta["groups"], d.max_degree) == (114, 19, 8)
    assert d.diameter(device="cpu") == 3
