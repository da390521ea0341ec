"""The paper's Tables 2–6 and Fig. 6 computed through the port.

A copy of the reference's ``benchmarks/paper_tables.py`` (its case
lists, the published values ``TABLE2_EXPECT``, ``PAPER_T4``, ``PAPER_T5``,
``PAPER_T6`` and the checks) and of ``benchmarks/paper_figures.py::fig6``,
on the port's graphs, cost model and layout.  Every table function returns
``(rows, max_rel_err_vs_paper)`` and runs its utilization sweeps on
``device`` (the card unless ``device="cpu"``); under the default engine
they take the orbit shortcut, one sweep per vertex orbit.
"""

from __future__ import annotations

import numpy as np

from ._device import resolve_device
from .core import (DirectNetworkSpec, cable_split, complete_bipartite_graph,
                   complete_graph, demi_pn_graph, dollars_per_node,
                   dragonfly_graph, electrical_groups, hamming_graph,
                   hypercube_graph, mlfm_graph, mms_graph, network_summary,
                   oft_graph, pn_graph, turan_graph, utilization,
                   watts_per_node)
from .core.reference import dragonfly_canonical_stats

__all__ = ["TABLE2_EXPECT", "PAPER_T4", "PAPER_T5", "PAPER_T6", "MMS_QS",
           "table2", "table3", "table4", "table5", "table6", "fig6",
           "TABLES"]


# ---------------------------------------------------------------------------
# Table 2: diameter / lim k̄ / lim u per family — verified on instances
# ---------------------------------------------------------------------------

TABLE2_EXPECT = {
    # family: (k, lim kbar, lim u)
    "complete": (1, 1.0, 1.0),
    "turan_r3": (2, 4 / 3, 1.0),
    "bipartite": (2, 1.5, 1.0),
    "hamming2": (2, 2.0, 1.0),
    "demi_pn": (2, 2.0, 1.0),
    "mms": (2, 2.0, 8 / 9),
    "pn": (3, 2.5, 1.0),
    "dragonfly": (3, 3.0, 1.0),
    "hamming3": (3, 3.0, 1.0),
}


def table2(device=None):
    device = resolve_device(device)
    rows, errs = [], []
    cases = [
        ("complete", complete_graph(24), None),
        ("turan_r3", turan_graph(24, 3), None),
        ("bipartite", complete_bipartite_graph(12), None),
        ("hamming2", hamming_graph(16, 2), None),
        ("demi_pn", demi_pn_graph(16), None),
        ("mms", mms_graph(17), None),
        ("pn", pn_graph(13), None),
        ("dragonfly", dragonfly_graph(6), dragonfly_canonical_stats(6)),
        ("hamming3", hamming_graph(8, 3), None),
    ]
    for name, g, canonical in cases:
        k_exp, kbar_lim, u_lim = TABLE2_EXPECT[name]
        if canonical is not None:
            kbar, u = canonical
            diam = g.diameter([0], device)
        else:
            rep = utilization(g, device=device)
            kbar, u, diam = rep.kbar, rep.u, rep.diameter
        # finite instances approach the limit from below/above; check trend
        kbar_err = abs(kbar - kbar_lim) / kbar_lim
        u_err = abs(u - u_lim) / u_lim
        rows.append({"family": name, "N": g.n, "diameter": diam,
                     "kbar": round(kbar, 4), "kbar_lim": kbar_lim,
                     "u": round(u, 4), "u_lim": round(u_lim, 4)})
        assert diam == k_exp, (name, diam, k_exp)
        errs.append(u_err if name == "mms" else max(kbar_err, u_err))
    # limits are asymptotic: instances must be within 20% and diameters exact
    return rows, max(errs)


# ---------------------------------------------------------------------------
# Table 3: structural parameters (closed forms) vs constructed graphs
# ---------------------------------------------------------------------------


def table3(device=None):
    """Structure only: ``device`` is accepted for a uniform call and
    unused."""
    rows, errs = [], []
    checks = [
        ("demi_pn", demi_pn_graph(8), 8, lambda q: (q * q + q + 1, q + 1)),
        ("pn", pn_graph(8), 8, lambda q: (2 * (q * q + q + 1), q + 1)),
        ("mms", mms_graph(13), 13, lambda q: (2 * q * q, (3 * q - 1) // 2)),
        ("dragonfly", dragonfly_graph(4), 4,
         lambda h: (4 * h**3 + 2 * h, 3 * h - 1)),
        ("hamming2", hamming_graph(9, 2), 9, lambda n: (n * n, 2 * (n - 1))),
        ("hypercube", hypercube_graph(7), 7, lambda n: (2**n, n)),
        ("bipartite", complete_bipartite_graph(9), 9, lambda n: (2 * n, n)),
    ]
    for name, g, p, formula in checks:
        n_exp, deg_exp = formula(p)
        rows.append({"family": name, "param": p, "N": g.n, "N_formula": n_exp,
                     "degree": g.max_degree, "degree_formula": deg_exp})
        errs.append(0.0 if (g.n == n_exp and g.max_degree == deg_exp)
                    else 1.0)
    return rows, max(errs)


# ---------------------------------------------------------------------------
# Tables 4 & 5: cases of use (~10k and ~25k compute nodes)
# ---------------------------------------------------------------------------

PAPER_T4 = {  # name: (T, R, N, Δ0, subscription, cost$, W)
    "Hamming K22^2": (10648, 64, 484, 22, 1.002, 1145.41, 8.15),
    "demi-PN(27)": (10598, 42, 757, 14, 0.999, 1282.59, 8.40),
    "SF MMS(19)": (9386, 42, 722, 13, 0.991, 1294.51, 9.05),
    "PN(23)": (9954, 33, 1106, 9, 0.921, 1546.83, 10.27),
    "dragonfly(7)": (9702, 27, 1386, 7, 0.994, 1404.42, 10.80),
}

PAPER_T5 = {
    "Hamming K29^2": (24389, 85, 841, 29, 1.001, 1237.43, 8.21),
    "demi-PN(37)": (26733, 57, 1407, 19, 0.999, 1314.29, 8.40),
    "SF MMS(27)": (26244, 59, 1458, 18, 0.976, 1344.11, 9.18),
    "PN(31)": (25818, 45, 1986, 13, 1.003, 1497.77, 9.70),
    "dragonfly(9)": (26406, 35, 2934, 9, 0.996, 1457.39, 10.89),
}


def _case_rows(cases, paper):
    rows, errs = [], []
    for name, g, delta0, kbar, u in cases:
        labels = electrical_groups(g, delta0)
        ne, no = cable_split(g, labels)
        spec = DirectNetworkSpec(
            name=name, terminals=int(round(g.n * delta0)),
            radix=int(round(g.max_degree + delta0)), routers=g.n,
            degree=g.max_degree, terminals_per_router=delta0, kbar=kbar, u=u,
            electrical_cables=ne, optical_cables=no)
        row = network_summary(spec)
        pt = paper[name]
        row["paper_cost"] = pt[5]
        row["paper_watts"] = pt[6]
        rows.append(row)
        # exact structural + power matches; $ depends on the cable layout —
        # the greedy grouping is allowed to beat the paper's
        assert (row["T"], row["R"], row["N"]) == pt[:3], (name, row)
        errs.append(abs(row["power_per_node_w"] - pt[6]) / pt[6])
        errs.append(abs(row["subscription"] - pt[4]) / pt[4])
        errs.append(max(0.0, (row["cost_per_node_usd"] - pt[5]) / pt[5]))
    return rows, max(errs)


def table4(device=None):
    device = resolve_device(device)
    g_h = hamming_graph(22, 2)
    g_d = demi_pn_graph(27)
    g_m = mms_graph(19)
    g_p = pn_graph(23)
    g_f = dragonfly_graph(7)
    rep_m = utilization(g_m, device=device)
    kb_f, u_f = dragonfly_canonical_stats(7)
    cases = [
        ("Hamming K22^2", g_h, 22, g_h.average_distance([0], device), 1.0),
        ("demi-PN(27)", g_d, 14, 2 - 28 / g_d.n,
         (2 * 729 + 28) / (2 * 27 * 28)),
        ("SF MMS(19)", g_m, 13, rep_m.kbar, rep_m.u),
        ("PN(23)", g_p, 9, (5 * 529 + 69 + 1) / (2 * 529 + 46 + 1), 1.0),
        ("dragonfly(7)", g_f, 7, kb_f, u_f),
    ]
    return _case_rows(cases, PAPER_T4)


def table5(device=None):
    device = resolve_device(device)
    g_h = hamming_graph(29, 2)
    g_d = demi_pn_graph(37)
    g_m = mms_graph(27)
    g_p = pn_graph(31)
    g_f = dragonfly_graph(9)
    rep_m = utilization(g_m, device=device)
    kb_f, u_f = dragonfly_canonical_stats(9)
    q = 37
    cases = [
        ("Hamming K29^2", g_h, 29, g_h.average_distance([0], device), 1.0),
        ("demi-PN(37)", g_d, 19, 2 - (q + 1) / g_d.n,
         (2 * q * q + q + 1) / (2 * q * (q + 1))),
        ("SF MMS(27)", g_m, 18, rep_m.kbar, rep_m.u),
        ("PN(31)", g_p, 13,
         (5 * 31 * 31 + 3 * 31 + 1) / (2 * 31 * 31 + 2 * 31 + 1), 1.0),
        ("dragonfly(9)", g_f, 9, kb_f, u_f),
    ]
    return _case_rows(cases, PAPER_T5)


# ---------------------------------------------------------------------------
# Table 6: indirect networks (MLFM / OFT)
# ---------------------------------------------------------------------------

PAPER_T6 = {
    "MLFM(22)": (9702, 42, 693, 21, 9702, 1297.18, 8.4),
    "MLFM(30)": (25230, 58, 1305, 29, 25230, 1321.76, 8.4),
    "OFT(16)": (9282, 34, 819, 17, 9282, 1282.19, 8.4),
    "OFT(23)": (26544, 48, 1659, 24, 26544, 1312.14, 8.4),
}


def table6(device=None):
    """Structure and cost only: ``device`` is accepted for a uniform call
    and unused."""
    rows, errs = [], []
    for name, build, p, delta0 in [
            ("MLFM(22)", mlfm_graph, 22, 21), ("MLFM(30)", mlfm_graph, 30, 29),
            ("OFT(16)", oft_graph, 16, 17), ("OFT(23)", oft_graph, 23, 24)]:
        g = build(p)
        leaf = g.meta["leaf_mask"]
        n_leaf = int(leaf.sum())
        spec = DirectNetworkSpec(
            name=name, terminals=n_leaf * delta0,
            radix=int(g.degrees.max()), routers=g.n,
            degree=int(g.degrees.max()), terminals_per_router=delta0,
            kbar=2.0, u=1.0, electrical_cables=0, optical_cables=g.num_edges,
            indirect=True)
        row = {"name": name, "T": spec.terminals, "R": spec.radix,
               "N": spec.routers, "delta0": delta0, "cables": g.num_edges,
               "cost_per_node_usd": round(dollars_per_node(spec), 2),
               "power_per_node_w": round(watts_per_node(spec), 2)}
        pt = PAPER_T6[name]
        rows.append(row)
        assert (row["T"], row["R"], row["N"], row["delta0"],
                row["cables"]) == pt[:5], (name, row, pt)
        errs.append(abs(row["cost_per_node_usd"] - pt[5]) / pt[5])
        errs.append(abs(row["power_per_node_w"] - pt[6]) / pt[6])
    return rows, max(errs)


# ---------------------------------------------------------------------------
# Fig. 6: MMS link utilization -> 8/9 (Section 4.2)
# ---------------------------------------------------------------------------

MMS_QS = [5, 7, 8, 9, 11, 13, 16, 17, 19, 23, 25]


def fig6(device=None):
    """Numeric u(MMS(q)) — converges to 8/9 (u=1 exactly at q=5, the
    Hoffman–Singleton Moore graph)."""
    device = resolve_device(device)
    rows = []
    for q in MMS_QS:
        rep = utilization(mms_graph(q), device=device)
        rows.append({"q": q, "N": 2 * q * q, "u": round(rep.u, 4),
                     "kbar": round(rep.kbar, 4)})
    assert abs(rows[0]["u"] - 1.0) < 1e-9  # Hoffman–Singleton
    tail = [r["u"] for r in rows[-4:]]
    err = abs(np.mean(tail) - 8 / 9) / (8 / 9)
    return rows, err


# name -> table function, in paper order
TABLES = {
    "table2_topological_params": table2,
    "table3_structural_params": table3,
    "table4_10k_nodes": table4,
    "table5_25k_nodes": table5,
    "table6_indirect": table6,
}
