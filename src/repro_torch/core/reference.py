"""Reference topologies of Sections 4.1/4.4 and Table 2/3.

complete, Turán, complete bipartite, Paley, Hamming 2D/3D (flattened
butterfly), dragonfly (balanced, absolute global arrangement), hypercube,
random regular.  The port's own copy of ``repro.core.reference``
(numpy only); ``random_regular_graph`` makes the same numpy draws from
the same seed, so it builds the same graph.
"""

from __future__ import annotations

import numpy as np

from .gf import get_field
from .graph import Graph

__all__ = [
    "complete_graph",
    "turan_graph",
    "complete_bipartite_graph",
    "paley_graph",
    "hamming_graph",
    "dragonfly_graph",
    "hypercube_graph",
    "random_regular_graph",
    "dragonfly_canonical_stats",
]


def complete_graph(n: int) -> Graph:
    i, j = np.triu_indices(n, k=1)
    g = Graph(n, np.stack([i, j], axis=1), name=f"K{n}")
    g.meta.update(family="complete")
    return g


def turan_graph(n: int, r: int) -> Graph:
    """Complete multipartite Turán(n, r): parts of size floor/ceil(n/r)."""
    part = np.arange(n) % r  # balanced assignment
    i, j = np.triu_indices(n, k=1)
    mask = part[i] != part[j]
    g = Graph(n, np.stack([i[mask], j[mask]], axis=1), name=f"Turan({n},{r})")
    g.meta.update(family="turan", r=r)
    return g


def complete_bipartite_graph(n: int) -> Graph:
    i = np.repeat(np.arange(n), n)
    j = n + np.tile(np.arange(n), n)
    g = Graph(2 * n, np.stack([i, j], axis=1), name=f"K{n},{n}")
    g.meta.update(family="bipartite", bipartite=True)
    return g


def paley_graph(q: int) -> Graph:
    """Paley(q), q ≡ 1 (mod 4) a prime power."""
    if q % 4 != 1:
        raise ValueError("Paley graph needs q ≡ 1 (mod 4)")
    f = get_field(q)
    sq = f.squares()
    a = np.arange(q)
    diff = f.sub(a[:, None], a[None, :])
    i, j = np.nonzero(np.isin(diff, sq))
    keep = i < j
    g = Graph(q, np.stack([i[keep], j[keep]], axis=1), name=f"Paley({q})")
    g.meta.update(family="paley", q=q)
    return g


def hamming_graph(n: int, dim: int = 2) -> Graph:
    """Hamming graph K_n^dim (2D = flattened butterfly / rook's graph)."""
    size = n**dim
    coords = np.stack(np.unravel_index(np.arange(size), (n,) * dim), axis=1)
    edges = []
    for d in range(dim):
        # vertices agreeing everywhere but coordinate d form a K_n
        other = [k for k in range(dim) if k != d]
        key = np.zeros(size, dtype=np.int64)
        for k in other:
            key = key * n + coords[:, k]
        order = np.argsort(key * n + coords[:, d], kind="stable")
        grp = order.reshape(-1, n)  # each row: the n vertices of one clique
        i, j = np.triu_indices(n, k=1)
        edges.append(np.stack([grp[:, i].ravel(), grp[:, j].ravel()], axis=1))
    g = Graph(size, np.concatenate(edges), name=f"Hamming(K{n}^{dim})")
    g.meta.update(family="hamming", side=n, dim=dim)
    return g


def dragonfly_graph(h: int) -> Graph:
    """Balanced dragonfly [27]: a=2h routers/group, h global links/router,
    g = 2h^2+1 groups, one global link between every pair of groups
    (absolute arrangement)."""
    a = 2 * h
    g_count = a * h + 1  # 2h^2 + 1
    n = a * g_count
    edges = []
    # local: complete graph within each group
    i, j = np.triu_indices(a, k=1)
    for grp in range(g_count):
        base = grp * a
        edges.append(np.stack([base + i, base + j], axis=1))
    # global: group A's port index e in [0, a*h) targets group (e if e < A else e+1);
    # the mirror port on group B is (A if A < B else A-1).
    glob = []
    for A in range(g_count):
        for e in range(a * h):
            B = e if e < A else e + 1
            if A < B:  # add each inter-group link once
                pa = A * a + e // h
                eb = A if A < B else A - 1
                pb = B * a + eb // h
                glob.append((pa, pb))
    edges.append(np.array(glob, dtype=np.int64))
    n_local = int(sum(e.shape[0] for e in edges[:-1]))
    gr = Graph(n, np.concatenate(edges), name=f"dragonfly({h})")
    gr.meta.update(family="dragonfly", h=h, groups=g_count, routers_per_group=a,
                   n_local_edges=n_local, n_global_edges=len(glob))
    return gr


def dragonfly_canonical_stats(h: int) -> tuple[float, float]:
    """(k̄, u) under CANONICAL dragonfly routing (l-g-l, one global hop).

    The paper's Table 2/4/5 dragonfly rows assume this routing, which is
    balanced (u = 1).  True shortest-path routing exploits g-g shortcuts
    through intermediate groups and is measurably unbalanced (u ≈ 0.74 at
    h = 7) — see EXPERIMENTS.md; utilization() reports that number.
    """
    a = 2 * h
    n = a * (a * h + 1)
    kbar = ((a - 1) * 1.0 + (n - a) * (3.0 - 2.0 / a)) / (n - 1)
    return kbar, 1.0


def hypercube_graph(n: int) -> Graph:
    size = 2**n
    v = np.arange(size)
    edges = [np.stack([v[v < (v ^ (1 << d))], (v ^ (1 << d))[v < (v ^ (1 << d))]], axis=1)
             for d in range(n)]
    g = Graph(size, np.concatenate(edges), name=f"Q{n}")
    g.meta.update(family="hypercube", dim=n)
    return g


def random_regular_graph(n: int, d: int, seed: int = 0) -> Graph:
    """Random d-regular graph via the pairing model with retry."""
    if (n * d) % 2:
        raise ValueError("n*d must be even")
    rng = np.random.default_rng(seed)
    for _ in range(200):
        stubs = np.repeat(np.arange(n), d)
        rng.shuffle(stubs)
        e = stubs.reshape(-1, 2)
        e.sort(axis=1)
        if np.any(e[:, 0] == e[:, 1]):
            continue
        key = e[:, 0] * n + e[:, 1]
        if len(np.unique(key)) != len(key):
            continue
        g = Graph(n, e, name=f"random({n},{d})")
        if g.is_connected():
            g.meta.update(family="random", d=d, seed=seed)
            return g
    raise RuntimeError("failed to sample a simple connected regular graph")
