"""Electrical-group layout (Section 5.3): partition routers into groups of
~500 compute nodes; intra-group cables are electrical, inter-group optical.

The port's counterpart of ``repro.core.layout``, numpy on the host.

Natural groupings are used where the topology has one (Hamming rows, MMS
column pairs, dragonfly group bundles, Baer subplanes for PN(p^2)); a greedy
edge-maximizing partitioner covers the rest (the paper's own demi-PN/PN
splits are produced the same way — 'trying to maximize the connections
inside a group').
"""

from __future__ import annotations

import numpy as np

from .graph import Graph
from .projective import subplane_classes, subplane_line_classes

__all__ = ["electrical_groups", "cable_split", "group_sizes"]


def electrical_groups(g: Graph, terminals_per_router: float,
                      target_nodes: int = 500) -> np.ndarray:
    """Return group label per router."""
    per_group = max(1, int(round(target_nodes / max(terminals_per_router, 1e-9))))
    fam = g.meta.get("family", "")
    if fam == "hamming" and g.meta.get("dim") == 2:
        n = g.meta["side"]
        return np.arange(g.n) // n  # rows (each a K_n clique)
    if fam == "mms":
        q = g.meta["q"]
        col = np.arange(g.n) // q  # column (s, x); pair (0,x) with (1,x)
        return col % (g.n // q // 2)
    if fam == "dragonfly":
        a = g.meta["routers_per_group"]
        merge = max(1, per_group // a)
        return (np.arange(g.n) // a) // merge
    if fam in ("pn", "demi_pn"):
        q = g.meta["q"]
        p = int(round(q**0.5))
        if p * p == q:
            cls = subplane_classes(q)
            if fam == "pn":
                cls = np.concatenate([cls, subplane_line_classes(q, cls)])
            # merge subplanes up to the target size
            sub_size = (2 if fam == "pn" else 1) * (p * p + p + 1)
            merge = max(1, per_group // sub_size)
            return cls // merge
        return _greedy_groups(g, per_group)
    return _greedy_groups(g, per_group)


def _greedy_groups(g: Graph, per_group: int) -> np.ndarray:
    """Seed-and-grow partition maximizing intra-group edges."""
    label = np.full(g.n, -1, dtype=np.int64)
    deg = g.degrees
    cur = 0
    order = np.argsort(-deg)  # high-degree seeds first
    adj_count = np.zeros(g.n, dtype=np.int64)  # neighbors in current group
    for seed in order:
        if label[seed] >= 0:
            continue
        members = [int(seed)]
        label[seed] = cur
        adj_count[:] = 0
        nb = g.neighbors(int(seed))
        np.add.at(adj_count, nb[label[nb] < 0], 1)
        while len(members) < per_group:
            free = label < 0
            if not free.any():
                break
            cand_scores = np.where(free, adj_count, -1)
            best = int(np.argmax(cand_scores))
            if cand_scores[best] < 0:
                break
            if cand_scores[best] == 0:
                # no attached candidate: stop growing rather than fragment
                break
            label[best] = cur
            members.append(best)
            nb = g.neighbors(best)
            np.add.at(adj_count, nb[label[nb] < 0], 1)
        cur += 1
    # any stragglers (isolated leftovers) get their own groups
    for v in np.nonzero(label < 0)[0]:
        label[v] = cur
        cur += 1
    return label


def cable_split(g: Graph, labels: np.ndarray) -> tuple[int, int]:
    """(electrical, optical) undirected cable counts for a grouping."""
    same = labels[g.edges[:, 0]] == labels[g.edges[:, 1]]
    return int(same.sum()), int((~same).sum())


def group_sizes(labels: np.ndarray) -> np.ndarray:
    return np.bincount(labels)
