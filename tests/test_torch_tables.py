"""repro_torch.sim.tables against repro.sim.tables: the route tables the
simulator steps read must equal the reference's element for element.

Split and spread are integer ratios and hval_rem a mean of integers, all
formed by one IEEE float64 division, so the comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import oft_graph, pn_graph
from repro.fabric.model import torus3d_graph
from repro.sim.tables import build_tables as ref_build_tables
from repro_torch.convert import graph_from_arrays, tables_from_numpy
from repro_torch.sim.kernel import step_aux
from repro_torch.sim.tables import build_tables

FIELDS = ("active", "head", "split", "deliver", "spread", "dist_act",
          "hval_rem")


def _graph(name):
    if name == "pn7":
        return pn_graph(7)
    if name == "pn16":
        return pn_graph(16)
    if name == "oft4":
        return oft_graph(4)
    return torus3d_graph(8, 16, 1)


def _pair(name, dtype=np.float64):
    ref = _graph(name)
    port = graph_from_arrays(ref.n, ref.edges, ref.meta)
    mask = ref.meta.get("leaf_mask")
    active = np.arange(ref.n) if mask is None else np.nonzero(mask)[0]
    want = ref_build_tables(ref, active, dtype=dtype)
    have = build_tables(port, active, dtype=getattr(torch, np.dtype(
        dtype).name), device="cpu")
    return want, have


@pytest.mark.parametrize("name", ["pn7", "pn16", "oft4", "torus8x16"])
def test_tables_equal_reference(name):
    want, have = _pair(name)
    assert (have.n, have.k, have.m) == (want.n, want.k, want.m)
    for key in FIELDS:
        np.testing.assert_array_equal(getattr(have, key).numpy(),
                                      getattr(want, key), err_msg=key)
    assert not have.faulted
    assert bool(have.routable.all()) and bool(have.slot_ok.sum() ==
                                              want.slot_ok.sum())


def test_tables_float32_equal_reference():
    want, have = _pair("pn7", np.float32)
    for key in ("split", "spread", "dist_act", "hval_rem"):
        got = getattr(have, key)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), getattr(want, key))


def test_tables_from_numpy_and_reverse_arcs():
    """Tables carried across from the reference's arrays equal the port's
    own, and the reverse-arc pairing is an involution on real arcs."""
    want, have = _pair("oft4")
    fields = {f: getattr(want, f) for f in
              ("n", "k", "m", "active", "head", "split", "deliver",
               "spread", "dist_act", "hval_rem", "slot_ok", "router_ok",
               "dest_ok", "routable")}
    conv = tables_from_numpy(device="cpu", **fields)
    for key in FIELDS:
        assert torch.equal(getattr(conv, key), getattr(have, key)), key
    aux = step_aux(have)
    rev = aux.rev_np
    real = np.nonzero(rev >= 0)[0]
    np.testing.assert_array_equal(rev[rev[real]], real)
    head = want.head.reshape(-1)
    np.testing.assert_array_equal(head[rev[real]], real // want.k)


def test_faulted_tables_not_ported():
    """Faulted tables are ported now: a link and a router fault of PN(3)
    compile to the reference's tables (masks exact, values equal), and
    a fault set that cuts a router off raises as the reference does."""
    from repro.core import FaultSet as RefFaultSet
    from repro_torch.convert import fault_set_from_arrays
    g = pn_graph(3)
    port = graph_from_arrays(g.n, g.edges, g.meta)
    ref_fs = RefFaultSet(links=[tuple(map(int, g.edges[0]))], routers=[20])
    fs = fault_set_from_arrays(ref_fs.links, ref_fs.routers)
    want = ref_build_tables(g, np.arange(g.n), faults=ref_fs)
    have = build_tables(port, np.arange(g.n), faults=fs, device="cpu")
    assert have.faulted and want.faulted
    for key in FIELDS + ("slot_ok", "router_ok", "dest_ok", "routable"):
        np.testing.assert_array_equal(getattr(have, key).numpy(),
                                      getattr(want, key), err_msg=key)
    cut = fault_set_from_arrays(
        [tuple(map(int, e)) for e in g.edges if 0 in e])
    with pytest.raises(ValueError, match="disconnect"):
        build_tables(port, np.arange(g.n), faults=cut, device="cpu")
