"""Finite projective planes P2(F_q) and the PN topology built on them.

The port's counterpart of ``repro.core.projective`` for the simulator's
main path: the canonical point set, its incidence relation and
``pn_graph`` (the incidence / Levi graph G_q, the paper's Definition
3.2).  numpy only; the graph feeds the torch route tables.

Point indexing (N = q^2+q+1):
  i in [0, q^2)        -> (1, x, y), x = i // q, y = i % q
  i in [q^2, q^2+q)    -> (0, 1, x), x = i - q^2
  i == q^2 + q         -> (0, 0, 1)
Lines are indexed by their dual points with the same scheme.
"""

from __future__ import annotations

import numpy as np

from .gf import GF, get_field, prime_power_decompose
from .graph import Graph

__all__ = ["num_points", "points", "normalize_points", "point_index",
           "incidence_lists", "pn_graph"]


def num_points(q: int) -> int:
    return q * q + q + 1


def points(q: int) -> np.ndarray:
    """Canonical representatives of P2(F_q), shape (N, 3)."""
    n = num_points(q)
    pts = np.zeros((n, 3), dtype=np.int64)
    i = np.arange(q * q)
    pts[: q * q, 0] = 1
    pts[: q * q, 1] = i // q
    pts[: q * q, 2] = i % q
    pts[q * q: q * q + q, 1] = 1
    pts[q * q: q * q + q, 2] = np.arange(q)
    pts[q * q + q] = (0, 0, 1)
    return pts


def normalize_points(f: GF, vecs: np.ndarray) -> np.ndarray:
    """Scale nonzero projective 3-vectors to canonical form (leading 1)."""
    vecs = np.asarray(vecs, dtype=np.int64)
    out = vecs.copy()
    a, b = vecs[..., 0], vecs[..., 1]
    lead = np.where(a != 0, a, np.where(b != 0, b, vecs[..., 2]))
    if np.any(lead == 0):
        raise ValueError("zero vector is not a projective point")
    scale = f.inv(lead)
    for k in range(3):
        out[..., k] = f.mul(vecs[..., k], scale)
    return out


def point_index(q: int, canon: np.ndarray) -> np.ndarray:
    """Canonical (..., 3) vectors -> point indices."""
    canon = np.asarray(canon, dtype=np.int64)
    a, b, c = canon[..., 0], canon[..., 1], canon[..., 2]
    return np.where(a == 1, b * q + c,
                    np.where(b == 1, q * q + c, q * q + q))


def incidence_lists(q: int) -> np.ndarray:
    """inc[j] = sorted indices of the q+1 points on line j (dual-indexed).

    Built case by case from the linear equation a + b*x + c*y = 0, so the
    whole incidence structure costs O(q^3) table lookups, never O(N^2).
    """
    f = get_field(q)
    pts = points(q)
    n = num_points(q)
    a, b, c = pts[:, 0], pts[:, 1], pts[:, 2]
    inc = np.empty((n, q + 1), dtype=np.int64)
    xs = np.arange(q, dtype=np.int64)

    m1 = c != 0  # lines with c != 0
    if m1.any():
        a1, b1, c1 = a[m1], b[m1], c[m1]
        cinv = f.inv(c1)
        # the one point of shape (0, 1, x): x = -b/c
        inc[m1, 0] = q * q + f.mul(f.neg(b1), cinv)
        # q points (1, x, y): y = -(a + b x)/c
        y = f.mul(f.neg(f.add(a1[:, None], f.mul(b1[:, None], xs[None, :]))),
                  cinv[:, None])
        inc[m1, 1:] = xs[None, :] * q + y

    m2 = (c == 0) & (b != 0)  # contains (0,0,1); points (1, -a/b, y) all y
    if m2.any():
        a2, b2 = a[m2], b[m2]
        inc[m2, 0] = q * q + q
        x0 = f.mul(f.neg(a2), f.inv(b2))
        inc[m2, 1:] = x0[:, None] * q + xs[None, :]

    m3 = (c == 0) & (b == 0)  # the line (1,0,0): (0,0,1) and all (0,1,x)
    if m3.any():
        inc[m3, 0] = q * q + q
        inc[m3, 1:] = q * q + xs[None, :]

    inc.sort(axis=1)
    return inc


def pn_graph(q: int) -> Graph:
    """PN: the incidence graph G_q (Definition 3.2).

    Vertices: [0, N) = points (side 0), [N, 2N) = lines (side 1).
    """
    if prime_power_decompose(q) is None:
        raise ValueError(f"q={q} must be a prime power")
    n = num_points(q)
    inc = incidence_lists(q)
    lines = np.repeat(np.arange(n), q + 1) + n
    pts = inc.reshape(-1)
    g = Graph(2 * n, np.stack([pts, lines], axis=1), name=f"PN({q})")
    g.meta.update(q=q, family="pn", bipartite=True)
    return g
