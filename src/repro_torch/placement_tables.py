"""The placement table (the reference's BENCH_4) computed through the
port.

A copy of the reference's ``benchmarks/placement_bench.py``: its job
profiles ``PROFILES``, its strategy list ``STRATEGIES``, its four
case-study fabrics ``placement_cases`` and the per-fabric table
``placement_one``, on the port's graphs and fabric layer.  Every routing
evaluation runs on ``device`` (the card unless ``device="cpu"``) under
``engine``.
"""

from __future__ import annotations

from ._device import resolve_device
from .core import build_topology, dragonfly_graph, pn_graph
from .fabric import StepProfile, fragmentation_sweep, placement_search
from .fabric.model import torus3d_graph

__all__ = ["PROFILES", "STRATEGIES", "placement_cases", "placement_one"]

PROFILES = {
    "ep_heavy": StepProfile({"all-to-all": 8e9, "all-reduce": 1e9}),
    "dp_heavy": StepProfile({"all-reduce": 6e9, "all-to-all": 5e8}),
}

STRATEGIES = ("linear", "group", "random", "orbit", "greedy_swap(30)")


def placement_cases():
    # (name, graph, mesh, axes, delta0, expect_packed); model-major meshes
    # so the linear baseline splits every TP/EP group across routers.
    # expect_packed=False on the torus: there the fragmentation direction
    # FLIPS — interleaving spreads co-tenants toward the uniform pattern a
    # high-diameter ring fabric likes, while the paper's diameter-2
    # families reward keeping groups on whole routers.
    return [
        ("pn16", pn_graph(16), (16, 16), ("model", "data"), 8, True),
        ("demi_pn9", build_topology("demi_pn", 9), (8, 8),
         ("model", "data"), 4, True),
        ("torus3d_444", torus3d_graph(4, 4, 4), (8, 8), ("model", "data"), 4,
         False),
        ("dragonfly3", dragonfly_graph(3), (8, 8), ("model", "data"), 4,
         True),
    ]


def placement_one(g, mesh, axes, delta0, expect_packed=True, routing="ugal",
                  engine: str | None = None, device=None):
    """(rows, summary, max_rel_err) for one fabric.

    rows: one dict per (profile, strategy) with theta/u/alpha plus a
    fragmentation row per layout.  max_rel_err embeds the live pipeline
    identities: on ep_heavy, how far the best NON-linear strategy falls
    below the linear baseline (must be <= 0 on every case here — search
    includes linear, so comparing against the overall best would be
    vacuous); how far packed falls below interleaved where packing is
    expected to win (must be <= 0; the torus flips, see
    placement_cases); and on pn16 specifically, 1.0 unless ep_heavy
    search STRICTLY beats linear.  dp_heavy has no baseline guard:
    linear legitimately WINS there (chip-major fill keeps DP-ring
    neighbours adjacent) — recorded in the summary, not an error."""
    device = resolve_device(device)
    rows = []
    summary = {}
    err = 0.0
    for pname, prof in PROFILES.items():
        out = placement_search(g, mesh, axes, delta0, prof,
                               strategies=STRATEGIES, routing=routing,
                               engine=engine, device=device)
        for strat, row in out["rows"].items():
            rows.append({"profile": pname, "strategy": strat,
                         "theta": round(row["theta"], 6),
                         "u": round(row["u"], 6),
                         "alpha": row["alpha"],
                         "max_bytes": row["max_bytes"]})
        lin = out["rows"]["linear"]["theta"]
        best = out["rows"][out["best"]]["theta"]
        best_nonlin = max(r["theta"] for s, r in out["rows"].items()
                          if s != "linear")
        summary[pname] = {"best": out["best"], "best_theta": best,
                          "best_nonlinear_theta": best_nonlin,
                          "linear_theta": lin,
                          "beats_linear": bool(best_nonlin > lin)}
        if pname == "ep_heavy":
            err = max(err, (lin - best_nonlin) / lin)
            if g.name == "PN(16)" and best_nonlin <= lin:
                err = max(err, 1.0)  # the search no longer beats linear

    jobs = [(mesh, axes, PROFILES["ep_heavy"])] * 2
    frag = fragmentation_sweep(g, jobs, delta0, routing=routing,
                               background="tornado", engine=engine,
                               device=device)
    for layout, row in frag["layouts"].items():
        rows.append({"profile": "frag_2x_ep_heavy", "strategy": layout,
                     "theta": round(row["theta"], 6),
                     "u": round(row["u"], 6), "alpha": row["alpha"]})
    fl = frag["layouts"]
    summary["fragmentation"] = {"best": frag["best"],
                                "packed_theta": fl["packed"]["theta"],
                                "interleaved_theta": fl["interleaved"]["theta"],
                                "expect_packed": expect_packed}
    if expect_packed:
        err = max(err, (fl["interleaved"]["theta"] - fl["packed"]["theta"])
                  / fl["interleaved"]["theta"])
    return rows, summary, err
