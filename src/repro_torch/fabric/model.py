"""Fabric models: the 3D torus constructor (the TPU-pod ICI reference point
that the paper's families are compared with).

The port's counterpart of ``repro.fabric.model::torus3d_graph`` (numpy
only); ``FabricModel`` and ``make_fabric`` are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import Graph

__all__ = ["torus3d_graph"]


def torus3d_graph(x: int, y: int, z: int) -> Graph:
    """3D torus.  Dimensions of size 1 add no links; a dimension of size
    2 adds one link per pair, not a doubled wrap."""
    n = x * y * z
    coords = np.stack(np.unravel_index(np.arange(n), (x, y, z)), 1)
    edges = []
    for d, size in enumerate((x, y, z)):
        if size == 1:
            continue
        nxt = coords.copy()
        nxt[:, d] = (nxt[:, d] + 1) % size
        dst = np.ravel_multi_index((nxt[:, 0], nxt[:, 1], nxt[:, 2]),
                                   (x, y, z))
        mask = np.ones(n, dtype=bool)
        if size == 2:  # one edge, not a doubled wrap
            mask = coords[:, d] == 0
        edges.append(np.stack([np.arange(n)[mask], dst[mask]], 1))
    g = Graph(n, np.concatenate(edges), name=f"torus3d({x},{y},{z})")
    g.meta.update(family="torus3d", dims=(x, y, z))
    return g
