"""repro_torch.core.cost, .layout and .select, and the table functions of
repro_torch.paper_tables, against the reference, on the CPU.

The cost model and the selector are plain Python, the layout numpy:
every output must equal the reference's to the last bit (field by field,
label array by label array).  The table functions, run with
``device="cpu"``, must give the rows and each table's ``max_rel_err`` of
the reference's ``benchmarks/paper_tables.py`` and
``benchmarks/paper_figures.py::fig6``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import benchmarks.paper_figures as ref_figures
import benchmarks.paper_tables as ref_tables
import repro.core as R
import repro_torch.core as P
import repro_torch.paper_tables as PT
from repro.fabric.model import torus3d_graph as ref_torus3d_graph
from repro_torch.fabric import torus3d_graph


@pytest.fixture(autouse=True)
def _one_thread():
    # torch on this box is slow multithreaded at tiny sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

SPECS = [
    dict(name="demi-PN(27)", terminals=10598, radix=42, routers=757,
         degree=28, terminals_per_router=14, kbar=2 - 28 / 757,
         u=(2 * 729 + 28) / (2 * 27 * 28), electrical_cables=9000,
         optical_cables=1598),
    dict(name="dragonfly(9)", terminals=26406, radix=35, routers=2934,
         degree=26, terminals_per_router=9, kbar=2.93, u=0.98,
         electrical_cables=20000, optical_cables=18142),
    dict(name="OFT(16)", terminals=9282, radix=34, routers=819, degree=34,
         terminals_per_router=17, kbar=2.0, u=1.0, electrical_cables=0,
         optical_cables=9282, indirect=True),
]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_cost_model_equals_reference(i):
    p, r = P.DirectNetworkSpec(**SPECS[i]), R.DirectNetworkSpec(**SPECS[i])
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert p.subscription == r.subscription
    assert P.dollars_per_node(p) == R.dollars_per_node(r)
    for opt in (None, 7.7432, 5.0):
        assert P.dollars_per_node(p, opt) == R.dollars_per_node(r, opt)
        assert (P.network_summary(p, P.CostParams(opt))
                == R.network_summary(r, R.CostParams(opt)))
    assert P.watts_per_node(p) == R.watts_per_node(r)
    assert P.network_summary(p) == R.network_summary(r)


def test_abstract_cost_model_equals_reference():
    from repro.core.cost import cost_per_node_generic as ref_generic
    from repro_torch.core.cost import cost_per_node_generic
    for delta, u, kbar in ((17, 1.0, 2.4385), (28, 0.93, 1.963), (3, 0.8, 3)):
        assert (P.max_terminals_per_router(delta, u, kbar)
                == R.max_terminals_per_router(delta, u, kbar))
        assert P.cost_figure(kbar, u) == R.cost_figure(kbar, u)
        for c in ((1.0, 1.0, 0.0), (2.0, 0.5, 3.0)):
            assert (cost_per_node_generic(64, kbar, u, *c)
                    == ref_generic(64, kbar, u, *c))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

LAYOUTS = [
    ("hamming6x2", lambda m: m.hamming_graph(6, 2), 6),
    ("mms5", lambda m: m.mms_graph(5), 5),
    ("dragonfly3", lambda m: m.dragonfly_graph(3), 3),
    ("pn4", lambda m: m.pn_graph(4), 3),         # Baer subplanes
    ("pn9", lambda m: m.pn_graph(9), 4),
    ("demi_pn9", lambda m: m.demi_pn_graph(9), 5),
    ("pn5", lambda m: m.pn_graph(5), 4),         # greedy
    ("demi_pn7", lambda m: m.demi_pn_graph(7), 6),
    ("oft3", lambda m: m.oft_graph(3), 2),
    ("hypercube6", lambda m: m.hypercube_graph(6), 10),
    ("torus4x4x2", lambda m: (torus3d_graph if m is P
                              else ref_torus3d_graph)(4, 4, 2), 20),
    ("random", lambda m: m.random_regular_graph(40, 5, seed=3), 12),
]


@pytest.mark.parametrize("name", [n for n, _, _ in LAYOUTS])
def test_electrical_groups_equal_reference(name):
    _, build, delta0 = next(c for c in LAYOUTS if c[0] == name)
    gp, gr = build(P), build(R)
    np.testing.assert_array_equal(gp.edges, gr.edges)
    for target in (500, 60):
        lp = P.electrical_groups(gp, delta0, target)
        lr = R.electrical_groups(gr, delta0, target)
        assert lp.dtype == lr.dtype
        np.testing.assert_array_equal(lp, lr)
        assert P.cable_split(gp, lp) == R.cable_split(gr, lr)
        np.testing.assert_array_equal(P.group_sizes(lp), R.group_sizes(lr))


def test_greedy_groups_cover_every_router():
    g = P.demi_pn_graph(7)
    labels = P.electrical_groups(g, 6, target_nodes=60)
    assert (labels >= 0).all() and len(labels) == g.n
    ne, no = P.cable_split(g, labels)
    assert ne + no == g.num_edges
    assert P.group_sizes(labels).max() <= 10


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------


def _same_realizations(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.cost_figure == b.cost_figure


@pytest.mark.parametrize("max_radix", [16, 48, 64])
def test_all_realizations_equal_reference(max_radix):
    got, want = P.all_realizations(max_radix), R.all_realizations(max_radix)
    assert list(got) == list(want)
    for fam in want:
        _same_realizations(got[fam], want[fam])


def test_realizations_for_family_equal_reference():
    from repro.core.select import FAMILIES as REF_FAMILIES
    from repro_torch.core.select import FAMILIES
    assert list(FAMILIES) == list(REF_FAMILIES)
    for fam in FAMILIES:
        _same_realizations(P.realizations_for_family(fam, 40),
                           R.realizations_for_family(fam, 40))
    for r in (3, 4):
        _same_realizations(P.realizations_for_family("turan", 30, r),
                           R.realizations_for_family("turan", 30, r))


@pytest.mark.parametrize("terminals,max_radix,slack",
                         [(10000, 64, 1.0), (25000, 64, 1.0),
                          (1000, 24, 1.2), (100000, 48, 1.0)])
def test_select_topology_equals_reference(terminals, max_radix, slack):
    got = P.select_topology(terminals, max_radix, slack)
    want = R.select_topology(terminals, max_radix, slack)
    _same_realizations(got, want)
    assert all(r.terminals >= terminals * slack for r in got)


# ---------------------------------------------------------------------------
# the paper's tables through the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ref_tables.TABLES))
def test_paper_table_equals_reference(name):
    rows, err = PT.TABLES[name](device="cpu")
    want_rows, want_err = ref_tables.TABLES[name]()
    assert rows == want_rows
    assert err == want_err


def test_fig6_equals_reference():
    rows, err = PT.fig6(device="cpu")
    want_rows, want_err = ref_figures.fig6()
    assert rows == want_rows
    assert err == want_err


def test_published_values_are_the_references():
    assert PT.TABLE2_EXPECT == ref_tables.TABLE2_EXPECT
    assert PT.PAPER_T4 == ref_tables.PAPER_T4
    assert PT.PAPER_T5 == ref_tables.PAPER_T5
    assert PT.PAPER_T6 == ref_tables.PAPER_T6
    assert PT.MMS_QS == ref_figures.MMS_QS
    assert list(PT.TABLES) == list(ref_tables.TABLES)


def test_table_functions_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for fn in (PT.table2, PT.table4, PT.table5, PT.fig6):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
