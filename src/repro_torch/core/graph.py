"""Graph container and batched BFS distances.

The port's counterpart of ``repro.core.graph``: the same edge-list + CSR
``Graph`` (numpy, host side) with its cached structure (bipartition, arc
sorts) and derived graphs (:meth:`Graph.subgraph`, which the fault model
compiles degraded graphs through), the one-source host BFS
:func:`bfs_distances`, and ``bfs_distances_batched`` advanced one BFS
level at a time as boolean frontier products in torch, on whatever
device the caller names (:func:`distance_distribution` and the route
tables run on it).  Graphs up to the ``util_dense_max`` perf flag's
vertex count (:data:`DENSE_MAX_N` by default) use a dense (N, N)
adjacency; larger ones a sparse CSR adjacency, so memory stays O(E +
S*N).  :func:`adjacency_dense` builds the dense
adjacency in any dtype on any device, for the BFS and the ``dense``
arc-load engine of :mod:`repro_torch.core.utilization`;
:func:`adjacency_csr` the mask+GEMM kernels' sparse copy, for its
``fused`` engine.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..perf import PerfFlags, flags

__all__ = ["Graph", "CsrAdjacency", "adjacency_csr", "adjacency_dense",
           "bank_order", "bfs_distances", "bfs_distances_batched",
           "distance_distribution", "DENSE_MAX_N"]

# the default largest vertex count whose BFS runs on a dense (N, N)
# adjacency; the util_dense_max perf flag sets it per run
DENSE_MAX_N = PerfFlags.util_dense_max

# ~64 MB of float32 frontier per source block
_BLOCK_BYTES = 64 << 20


@dataclass
class Graph:
    """Undirected simple graph as an edge list + CSR adjacency."""

    n: int
    edges: np.ndarray  # (E, 2) int64, each undirected edge once
    name: str = ""
    meta: dict = field(default_factory=dict)

    indptr: np.ndarray = field(init=False, repr=False)
    indices: np.ndarray = field(init=False, repr=False)
    # arc k is (arc_src[k] -> indices[k]); arc_edge_id[k] its edge id
    arc_src: np.ndarray = field(init=False, repr=False)
    arc_edge_id: np.ndarray = field(init=False, repr=False)

    def __post_init__(self) -> None:
        e = np.asarray(self.edges, dtype=np.int64).reshape(-1, 2)
        if e.size and (e.min() < 0 or e.max() >= self.n):
            raise ValueError("edge endpoint out of range")
        if np.any(e[:, 0] == e[:, 1]):
            raise ValueError("self-loop")
        # dedup undirected edges, keeping first-seen order
        key = np.sort(e, axis=1)
        _, uniq_idx = np.unique(key[:, 0] * self.n + key[:, 1],
                                return_index=True)
        e = key[np.sort(uniq_idx)]
        self.edges = e
        m = e.shape[0]
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        eid = np.concatenate([np.arange(m), np.arange(m)])
        order = np.argsort(src, kind="stable")
        src, dst, eid = src[order], dst[order], eid[order]
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        self.indptr = np.cumsum(indptr)
        self.indices = dst
        self.arc_src = src
        self.arc_edge_id = eid
        self._struct_cache: dict = {"__sig__": self._structure_signature()}

    @functools.cached_property
    def kernel_indices(self) -> np.ndarray:
        """``indices`` in :func:`bank_order`, the mask+GEMM kernels' copy
        (computed once; ``indices`` keeps its arc order)."""
        return bank_order(self.indptr, self.indices)

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    def is_regular(self) -> bool:
        d = self.degrees
        return bool(d.size == 0 or (d == d[0]).all())

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]

    # ---- cached structure: stamped with a structure signature, so a
    # graph whose edges were changed in place never serves stale arrays;
    # derived graphs go through the constructor (subgraph) ----
    def _structure_signature(self) -> tuple:
        e = self.edges
        return (self.n, e.shape[0],
                int(e[:, 0].sum()) if e.size else 0,
                int(e[:, 1].sum()) if e.size else 0)

    def _struct(self, key, build):
        sig = self._structure_signature()
        cache = getattr(self, "_struct_cache", None)
        if cache is None or cache.get("__sig__") != sig:
            cache = {"__sig__": sig}
            self._struct_cache = cache
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def bipartition(self) -> np.ndarray | None:
        """2-colouring ``side[v]`` in {0, 1} if the graph is bipartite,
        else None (BFS parity per connected component)."""

        def build():
            side = np.full(self.n, -1, dtype=np.int8)
            for start in range(self.n):
                if side[start] >= 0:
                    continue
                dist = bfs_distances(self, start)
                comp = dist >= 0
                side[comp] = (dist[comp] % 2).astype(np.int8)
            u, v = self.edges[:, 0], self.edges[:, 1]
            ok = bool((side[u] != side[v]).all()) if self.num_edges else True
            return side if ok else None

        return self._struct("bip", build)

    def arc_sort_by_pair(self) -> tuple[np.ndarray, np.ndarray]:
        """(order, keys): arc ids sorted by (src, dst) and the sorted
        packed keys ``src * n + dst``, a vectorized arc-id lookup."""

        def build():
            keys = self.arc_src * np.int64(self.n) + self.indices
            order = np.argsort(keys, kind="stable")
            return order, keys[order]

        return self._struct("pairsort", build)

    def reverse_arcs(self) -> np.ndarray:
        """rev[k] = arc id of (v -> u) for arc k = (u -> v)."""

        def build():
            order, keys = self.arc_sort_by_pair()
            qkeys = self.indices * np.int64(self.n) + self.arc_src
            return order[np.searchsorted(keys, qkeys)]

        return self._struct("revarc", build)

    def arcs_by_dst(self) -> np.ndarray:
        """Arc ids sorted by destination; group v occupies
        ``indptr[v]:indptr[v+1]`` (the graph is undirected)."""
        return self._struct("dstsort",
                            lambda: np.argsort(self.indices, kind="stable"))

    # ---- derived graphs ----
    def subgraph(self, edge_mask=None, vertex_mask=None, name: str = "",
                 meta: dict | None = None) -> "Graph":
        """Derived graph built through the constructor, so every cache is
        rebuilt.  ``edge_mask`` is an (E,) bool keep-mask over
        ``self.edges``; ``vertex_mask`` an (N,) bool keep-mask: dropped
        vertices take their edges with them and survivors are relabelled
        compactly in index order.  ``meta`` is not inherited: the caller
        states what still holds."""
        e = self.edges
        keep = (np.ones(e.shape[0], dtype=bool) if edge_mask is None
                else np.asarray(edge_mask, dtype=bool).copy())
        if keep.shape != (e.shape[0],):
            raise ValueError(f"edge_mask is {keep.shape}, graph has "
                             f"{e.shape[0]} edges")
        if vertex_mask is None:
            return Graph(self.n, e[keep], name=name, meta=dict(meta or {}))
        vm = np.asarray(vertex_mask, dtype=bool)
        if vm.shape != (self.n,):
            raise ValueError(f"vertex_mask is {vm.shape}, graph has "
                             f"N={self.n}")
        keep &= vm[e[:, 0]] & vm[e[:, 1]]
        new_id = np.cumsum(vm) - 1
        return Graph(int(vm.sum()), new_id[e[keep]], name=name,
                     meta=dict(meta or {}))

    # ---- distances (the distribution runs on ``device``) ----
    def distances_from(self, source: int) -> np.ndarray:
        return bfs_distances(self, source)

    def distance_distribution(self, sources=None, device=None) -> np.ndarray:
        return distance_distribution(self, sources, device)

    def diameter(self, sources=None, device=None) -> int:
        return len(self.distance_distribution(sources, device)) - 1

    def average_distance(self, sources=None, device=None) -> float:
        """Mean distance over ordered pairs of distinct vertices (k̄)."""
        w = self.distance_distribution(sources, device).astype(np.float64)
        total_pairs = w[1:].sum()
        return float((np.arange(len(w)) * w).sum() / total_pairs)

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        return bool((bfs_distances(self, 0) >= 0).all())


class CsrAdjacency(NamedTuple):
    """A weighted adjacency in CSR form on one device: row ``v`` holds
    ``data[indptr[v]:indptr[v+1]]`` at columns ``indices[...]``
    (int32 index arrays, as the mask+GEMM kernels take them)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor


def adjacency_dense(g: Graph, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """Dense (N, N) 0/1 adjacency in ``dtype`` on ``device``."""
    device = resolve_device(device)
    a = torch.zeros((g.n, g.n), dtype=dtype, device=device)
    if g.num_edges:
        u = torch.as_tensor(g.edges[:, 0], device=device)
        v = torch.as_tensor(g.edges[:, 1], device=device)
        a[u, v] = 1
        a[v, u] = 1
    return a


# shared-memory banks a row of the mask+GEMM kernels' float64 operand
# spreads over (32 banks of 4 bytes, two a float64)
KERNEL_BANKS = 16


def bank_order(indptr: np.ndarray, indices: np.ndarray,
               banks: int = KERNEL_BANKS) -> np.ndarray:
    """``indices`` with each row's entries dealt round-robin over the
    residues ``u mod banks``: the first entry of each residue in turn,
    then the second, each residue in first-seen order.  Sixteen lanes of
    the mask+GEMM kernels read sixteen consecutive entries of a column at
    once, from a row of x in shared memory; dealt this way they fall on
    different banks wherever the column's rows allow."""
    n, m = len(indptr) - 1, len(indices)
    if m == 0:
        return indices.copy()
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    res = indices.astype(np.int64) % banks
    key = row * banks + res
    grouped = np.argsort(key, kind="stable")       # by (row, residue, pos)
    key = key[grouped]
    first = np.r_[0, np.flatnonzero(np.diff(key)) + 1]
    rank = np.arange(m) - np.repeat(first, np.diff(np.r_[first, m]))
    turn = np.empty(m, dtype=np.int64)
    turn[grouped] = rank * banks + key % banks
    span = int(turn.max()) + 1
    return indices[np.argsort(row * span + turn, kind="stable")]


def adjacency_csr(g: Graph, dtype=torch.float64,
                  device=None) -> CsrAdjacency:
    """The graph's CSR adjacency (its ``indptr``; each row's neighbours
    in :func:`bank_order`, ``g.kernel_indices``)
    with unit values in ``dtype`` on ``device``.  The adjacency is
    symmetric, so this is also its compressed-column form, which the
    mask+GEMM kernels take."""
    device = resolve_device(device)
    return CsrAdjacency(
        torch.as_tensor(g.indptr, dtype=torch.int32, device=device),
        torch.as_tensor(g.kernel_indices, dtype=torch.int32, device=device),
        torch.ones(len(g.indices), dtype=dtype, device=device))


def _adjacency(g: Graph, device: torch.device) -> torch.Tensor:
    """float32 adjacency on ``device`` for the BFS: dense up to the
    ``util_dense_max`` flag's vertex count, a sparse CSR tensor above."""
    if g.n <= flags().util_dense_max:
        return adjacency_dense(g, torch.float32, device)
    # the graph's own order (not the kernels' bank order): torch's sparse
    # CSR products take each row's columns in the order the graph builds
    return torch.sparse_csr_tensor(
        torch.as_tensor(g.indptr, dtype=torch.int64, device=device),
        torch.as_tensor(g.indices, dtype=torch.int64, device=device),
        torch.ones(len(g.indices), dtype=torch.float32, device=device),
        size=(g.n, g.n))


def bfs_distances_batched(g: Graph, sources, device=None) -> torch.Tensor:
    """Level-synchronous BFS from a block of sources at once: an (S, N)
    int32 tensor on ``device``, -1 for unreachable.  Each level is one
    frontier product ``(S, N) @ (N, N)``; 0/1 operands with sums at most
    the degree are exact in float32 (and in TF32)."""
    device = resolve_device(device)
    sources = torch.as_tensor(np.asarray(sources, dtype=np.int64),
                              device=device)
    s_tot = len(sources)
    out = torch.empty((s_tot, g.n), dtype=torch.int32, device=device)
    if s_tot == 0:
        return out
    adj = _adjacency(g, device)
    sparse = adj.layout == torch.sparse_csr
    block = max(32, _BLOCK_BYTES // max(4 * g.n, 1))
    for lo in range(0, s_tot, block):
        chunk = sources[lo: lo + block]
        s = len(chunk)
        rows = torch.arange(s, device=device)
        dist = torch.full((s, g.n), -1, dtype=torch.int32, device=device)
        dist[rows, chunk] = 0
        frontier = torch.zeros((s, g.n), dtype=torch.float32, device=device)
        frontier[rows, chunk] = 1.0
        lvl = 0
        while True:
            lvl += 1
            # the adjacency is symmetric: frontier @ A == (A @ frontier^T)^T
            hit = (adj @ frontier.T).T if sparse else frontier @ adj
            new = (hit > 0) & (dist < 0)
            if not bool(new.any()):
                break
            dist[new] = lvl
            frontier = new.to(torch.float32)
        out[lo: lo + s] = dist
    return out


def bfs_distances(g: Graph, source: int) -> np.ndarray:
    """BFS distances from one source on the host (numpy); -1 for
    unreachable."""
    dist = np.full(g.n, -1, dtype=np.int64)
    dist[source] = 0
    frontier = np.array([source], dtype=np.int64)
    d = 0
    while frontier.size:
        nbrs = _gather_neighbors(g, frontier)
        nbrs = nbrs[dist[nbrs] < 0]
        if nbrs.size == 0:
            break
        frontier = np.unique(nbrs)
        d += 1
        dist[frontier] = d
    return dist


def _gather_neighbors(g: Graph, frontier: np.ndarray) -> np.ndarray:
    """The neighbour lists of all frontier vertices, concatenated."""
    starts = g.indptr[frontier]
    counts = g.indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    idx = np.ones(total, dtype=np.int64)
    cum = np.cumsum(counts)
    idx[0] = starts[0]
    idx[cum[:-1]] = starts[1:] - (starts[:-1] + counts[:-1]) + 1
    idx = np.cumsum(idx)
    return g.indices[idx]


def distance_distribution(g: Graph, sources=None, device=None) -> np.ndarray:
    """W(t): the number of ordered (s, t != s) pairs at distance t,
    averaged over the chosen sources (all vertices by default), so W(t)
    is per vertex, the paper's convention.  The BFS runs a block of
    sources at a time on ``device``; the integer counts are summed
    exactly, so the result equals the reference's."""
    device = resolve_device(device)
    if sources is None:
        sources = np.arange(g.n)
    sources = np.asarray(sources, dtype=np.int64)
    block = max(32, _BLOCK_BYTES // max(4 * g.n, 1))
    acc = np.zeros(1, dtype=np.float64)
    for lo in range(0, len(sources), block):
        dist = bfs_distances_batched(g, sources[lo: lo + block], device)
        if bool((dist < 0).any()):
            raise ValueError("graph is disconnected")
        w = torch.bincount(dist.reshape(-1).to(torch.int64)).cpu().numpy()
        if len(w) > len(acc):
            acc = np.pad(acc, (0, len(w) - len(acc)))
        acc[: len(w)] += w
    acc /= len(sources)
    acc[0] = 1.0
    return acc
