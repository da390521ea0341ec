"""repro_torch.core against repro.core: PN graphs, BFS distances,
traffic demands and the graph converter, on the CPU.

Every comparison here is exact (integer structure, and demands built by
the same numpy arithmetic from the same seeds)."""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import pn_graph as ref_pn_graph
from repro.core.graph import bfs_distances_batched as ref_bfs
from repro.core.traffic import make_pattern as ref_make_pattern
from repro.fabric.model import torus3d_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import (bfs_distances_batched, make_pattern,
                              normalize_demand, pn_graph)

TORUS_REF = torus3d_graph(8, 16, 1)
TORUS = graph_from_arrays(TORUS_REF.n, TORUS_REF.edges, TORUS_REF.meta,
                          name=TORUS_REF.name)
PN7_REF = ref_pn_graph(7)
PN7 = pn_graph(7)

PATTERNS = ["uniform", "bit_reversal", "transpose", "shift(3)", "tornado",
            "random_permutation(7)", "hot_region(0.25,4)",
            "collective(all-reduce)", "collective(ring-all-reduce)"]


@pytest.mark.parametrize("q", [2, 3, 4, 5, 7, 8, 9])
def test_pn_graph_matches_reference(q):
    ref, got = ref_pn_graph(q), pn_graph(q)
    assert got.n == ref.n
    np.testing.assert_array_equal(got.edges, ref.edges)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.arc_edge_id, ref.arc_edge_id)
    assert got.max_degree == ref.max_degree == q + 1
    assert got.meta == ref.meta


@pytest.mark.parametrize("which", ["pn7", "pn16", "torus8x16"])
def test_bfs_distances_match_reference(which):
    if which == "torus8x16":
        ref, got = TORUS_REF, TORUS
    elif which == "pn7":
        ref, got = PN7_REF, PN7
    else:
        ref, got = ref_pn_graph(16), pn_graph(16)
    src = np.arange(ref.n)
    want = ref_bfs(ref, src).astype(np.int64)
    have = bfs_distances_batched(got, src, device="cpu").numpy()
    np.testing.assert_array_equal(have, want)


def test_bfs_sparse_adjacency_matches_reference(monkeypatch):
    """Graphs above DENSE_MAX_N advance the frontier through a sparse CSR
    adjacency; forced here on a small graph."""
    import repro_torch.core.graph as graph_mod
    monkeypatch.setattr(graph_mod, "DENSE_MAX_N", 10)
    src = np.arange(0, TORUS_REF.n, 3)
    want = ref_bfs(TORUS_REF, src).astype(np.int64)
    have = bfs_distances_batched(TORUS, src, device="cpu").numpy()
    np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("graph", ["pn7", "torus8x16"])
@pytest.mark.parametrize("spec", PATTERNS)
def test_pattern_demand_matches_reference(graph, spec):
    ref, got = (PN7_REF, PN7) if graph == "pn7" else (TORUS_REF, TORUS)
    want = ref_make_pattern(spec).demand(ref, None)
    have = make_pattern(spec).demand(got, None)
    np.testing.assert_array_equal(have, want)
    np.testing.assert_array_equal(normalize_demand(have),
                                  want / want.sum(axis=1).max())


def test_matrix_pattern_and_leaf_mask():
    rng = np.random.default_rng(0)
    mat = rng.random((PN7.n, PN7.n))
    np.testing.assert_array_equal(make_pattern(mat).demand(PN7, None),
                                  ref_make_pattern(mat).demand(PN7_REF, None))
    mask = np.zeros(PN7.n, dtype=bool)
    mask[:57] = True
    np.testing.assert_array_equal(
        make_pattern("tornado").demand(PN7, mask),
        ref_make_pattern("tornado").demand(PN7_REF, mask))


def test_graph_from_arrays_round_trips():
    g = graph_from_arrays(PN7_REF.n, PN7_REF.edges, PN7_REF.meta)
    np.testing.assert_array_equal(g.indptr, PN7.indptr)
    np.testing.assert_array_equal(g.indices, PN7.indices)
    back = graph_from_arrays(g.n, g.edges, g.meta)
    np.testing.assert_array_equal(back.edges, g.edges)
    assert back.meta == g.meta == PN7_REF.meta
    assert TORUS.meta["dims"] == (8, 16, 1)
    np.testing.assert_array_equal(TORUS.indices, TORUS_REF.indices)
    with pytest.raises(ValueError, match="self-loop"):
        graph_from_arrays(3, [[0, 0]])
