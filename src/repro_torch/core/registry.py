"""Name -> graph constructor registry for benchmarks, tests and the CLI:
the port's counterpart of ``repro.core.registry``, over the port's own
constructors."""

from __future__ import annotations

from typing import Callable

from .graph import Graph
from .mms import mms_graph
from .projective import demi_pn_graph, mlfm_graph, oft_graph, pn_graph
from .reference import (
    complete_bipartite_graph,
    complete_graph,
    dragonfly_graph,
    hamming_graph,
    hypercube_graph,
    paley_graph,
    random_regular_graph,
    turan_graph,
)

__all__ = ["TOPOLOGIES", "build_topology"]

TOPOLOGIES: dict[str, Callable[..., Graph]] = {
    "pn": pn_graph,
    "demi_pn": demi_pn_graph,
    "oft": oft_graph,
    "mlfm": mlfm_graph,
    "mms": mms_graph,
    "slimfly": mms_graph,
    "complete": complete_graph,
    "turan": turan_graph,
    "bipartite": complete_bipartite_graph,
    "paley": paley_graph,
    "hamming": hamming_graph,
    "dragonfly": dragonfly_graph,
    "hypercube": hypercube_graph,
    "random": random_regular_graph,
}


def build_topology(name: str, *args, **kwargs) -> Graph:
    try:
        fn = TOPOLOGIES[name]
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; options: {sorted(TOPOLOGIES)}") from None
    return fn(*args, **kwargs)
