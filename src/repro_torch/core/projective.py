"""Finite projective planes P2(F_q) and the paper's topologies built on
them.

The port's counterpart of ``repro.core.projective`` (numpy only; the
graphs feed the torch route tables and arc-load engines):
  * the canonical point set of P2(F_q) and its incidence relation,
  * PN      = G_q (Definition 3.2): the incidence / Levi graph,
  * demi-PN = the point/line identified quotient (Definition 3.6),
  * OFT     = the two-level Orthogonal Fat Tree (Definition 6.1),
  * MLFM    the Fujitsu Multi-layer Full-Mesh (Section 6, Fig. 10),
  * the Baer-subplane partition of P2(F_{p^2}) via a Singer cycle
    (Fig. 2), used for electrical-group layout.

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
           "incidence_lists", "self_orthogonal_points", "pn_graph",
           "demi_pn_graph", "oft_graph", "mlfm_graph", "subplane_classes",
           "subplane_line_classes"]


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


def self_orthogonal_points(q: int) -> np.ndarray:
    """Indices of the q+1 points P with P ⊥ P (the degree-q vertices of
    demi-PN)."""
    f = get_field(q)
    pts = points(q)
    return np.nonzero(f.dot3(pts, pts) == 0)[0]


def pn_graph(q: int) -> Graph:
    """PN: the incidence graph G_q (Definition 3.2).

    Vertices: [0, N) = points (side 0), [N, 2N) = lines (side 1).
    """
    _check_prime_power(q)
    n = num_points(q)
    inc = incidence_lists(q)
    lines = np.repeat(np.arange(n), q + 1) + n
    pts = inc.reshape(-1)
    g = Graph(2 * n, np.stack([pts, lines], axis=1), name=f"PN({q})")
    g.meta.update(q=q, family="pn", bipartite=True)
    return g


def demi_pn_graph(q: int) -> Graph:
    """demi-PN: the modified incidence graph of Definition 3.6, points
    and lines identified; degrees q (the self-orthogonal points) and
    q + 1."""
    _check_prime_power(q)
    n = num_points(q)
    inc = incidence_lists(q)
    lines = np.repeat(np.arange(n), q + 1)
    pts = inc.reshape(-1)
    mask = pts != lines  # drop the self-orthogonal fixed incidences
    g = Graph(n, np.stack([pts[mask], lines[mask]], axis=1),
              name=f"demi-PN({q})")
    g.meta.update(q=q, family="demi_pn", bipartite=False)
    return g


def oft_graph(q: int) -> Graph:
    """OFT: the two-level Orthogonal Fat Tree (Definition 6.1).

    Columns: [0, N) leaves, [N, 2N) spines, [2N, 3N) leaves; only leaves
    send and receive (``meta["leaf_mask"]``).
    """
    _check_prime_power(q)
    n = num_points(q)
    inc = incidence_lists(q)
    lines = np.repeat(np.arange(n), q + 1)
    pts = inc.reshape(-1)
    e0 = np.stack([pts, lines + n], axis=1)          # {(0,P),(1,L)}, P ⊥ L
    e1 = np.stack([pts + n, lines + 2 * n], axis=1)  # {(1,P),(2,L)}, P ⊥ L
    g = Graph(3 * n, np.concatenate([e0, e1]), name=f"OFT({q})")
    leaf = np.ones(3 * n, dtype=bool)
    leaf[n: 2 * n] = False
    g.meta.update(q=q, family="oft", indirect=True, leaf_mask=leaf)
    return g


def mlfm_graph(n_mesh: int) -> Graph:
    """Fujitsu Multi-layer Full-Mesh from the incidence graph of K_n
    (Fig. 10).  Leaves (a, i), a in [0, n), i in [0, n-1); spine {a, b}
    adjacent to every replica of a and of b.  Leaves first, then spines.
    """
    n = n_mesh
    n_leaves = n * (n - 1)
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    edges = []
    for s, (a, b) in enumerate(pairs):
        spine = n_leaves + s
        for i in range(n - 1):
            edges.append((a * (n - 1) + i, spine))
            edges.append((b * (n - 1) + i, spine))
    g = Graph(n_leaves + len(pairs), np.array(edges, dtype=np.int64),
              name=f"MLFM({n})")
    leaf = np.zeros(g.n, dtype=bool)
    leaf[:n_leaves] = True
    g.meta.update(n_mesh=n, family="mlfm", indirect=True, leaf_mask=leaf)
    return g


# ---------------------------------------------------------------------------
# Baer-subplane partition via a Singer cycle (layout of Fig. 2)
# ---------------------------------------------------------------------------


def _find_irreducible_cubic(f: GF, rng: np.random.Generator) -> np.ndarray:
    """Monic cubic over GF(q) with no roots (a cubic, so irreducible)."""
    xs = np.arange(f.q, dtype=np.int64)
    while True:
        c0, c1, c2 = (int(rng.integers(f.q)) for _ in range(3))
        if c0 == 0:
            continue
        # x^3 + c2 x^2 + c1 x + c0 at every x
        v = f.add(f.add(f.pow(xs, 3), f.mul(c2, f.mul(xs, xs))),
                  f.add(f.mul(c1, xs), c0))
        if not np.any(v == 0):
            return np.array([c0, c1, c2, 1], dtype=np.int64)


def _ext_mul(f: GF, g: np.ndarray, u: tuple, v: tuple) -> tuple:
    """Product of two GF(q)[t]/(g) elements given as 3-tuples over GF(q)."""
    prod = [0] * 5
    for i in range(3):
        if u[i] == 0:
            continue
        for j in range(3):
            prod[i + j] = int(f.add(prod[i + j], f.mul(u[i], v[j])))
    # reduce degree 4, then 3, by the monic g = t^3 + g2 t^2 + g1 t + g0
    for d in (4, 3):
        c = prod[d]
        if c:
            prod[d] = 0
            for k in range(3):
                prod[d - 3 + k] = int(f.sub(prod[d - 3 + k], f.mul(c, g[k])))
    return tuple(prod[:3])


def _ext_pow(f: GF, g: np.ndarray, u: tuple, k: int) -> tuple:
    out = (1, 0, 0)
    base = u
    while k:
        if k & 1:
            out = _ext_mul(f, g, out, base)
        base = _ext_mul(f, g, base, base)
        k >>= 1
    return out


def _factorize(n: int) -> list[int]:
    fs, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def subplane_classes(q: int, seed: int = 0) -> np.ndarray:
    """Partition the points of P2(F_{p^2}) into p^2 - p + 1 Baer
    subplanes: ``class[i]`` for each point index i.  Uses the Singer
    cycle of PG(2, q) (points are F_{q^3}*/F_q*, a cyclic group of order
    N); the cosets of its subgroup of order p^2 + p + 1 are the
    subplanes.  The same seed makes the same numpy draws as the
    reference, so the classes are the same."""
    if prime_power_decompose(q) is None:
        raise ValueError(f"q={q} not a prime power")
    p2 = int(round(q ** 0.5))
    if p2 * p2 != q:
        raise ValueError(f"q={q} is not a square; no Baer-subplane "
                         f"partition")
    f = get_field(q)
    rng = np.random.default_rng(seed)
    g = _find_irreducible_cubic(f, rng)
    order = q ** 3 - 1
    factors = _factorize(order)
    # a primitive element xi of GF(q^3)*
    while True:
        xi = tuple(int(rng.integers(f.q)) for _ in range(3))
        if xi == (0, 0, 0):
            continue
        if all(_ext_pow(f, g, xi, order // pf) != (1, 0, 0)
               for pf in factors):
            break
    n = num_points(q)
    r = q - p2 + 1  # p^2 - p + 1 classes
    classes = np.full(n, -1, dtype=np.int64)
    cur = (1, 0, 0)
    for i in range(n * (q - 1)):
        # the Singer cycle on points has period N: normalize and assign
        vec = np.array([cur[0], cur[1], cur[2]], dtype=np.int64)
        idx = int(point_index(q, normalize_points(f, vec)))
        if classes[idx] < 0:
            classes[idx] = i % r
        cur = _ext_mul(f, g, cur, xi)
        if not np.any(classes < 0):
            break
    if np.any(classes < 0):
        raise RuntimeError("Singer cycle failed to cover all points")
    return classes


def subplane_line_classes(q: int, point_classes: np.ndarray) -> np.ndarray:
    """Class of each line: the one Baer subplane it meets in p + 1
    points (it meets every other in exactly one), so each layout group
    is an induced copy of G_p in G_{p^2} (Figure 2)."""
    p = int(round(q ** 0.5))
    inc = incidence_lists(q)
    n = num_points(q)
    r = q - p + 1
    cls_on_line = point_classes[inc]  # (N, q+1)
    counts = np.zeros((n, r), dtype=np.int64)
    rows = np.repeat(np.arange(n), q + 1)
    np.add.at(counts, (rows, cls_on_line.reshape(-1)), 1)
    line_cls = counts.argmax(axis=1)
    if not (counts.max(axis=1) == p + 1).all():
        raise RuntimeError("Baer partition property violated")
    return line_cls


def _check_prime_power(q: int) -> None:
    if prime_power_decompose(q) is None:
        raise ValueError(f"q={q} must be a prime power")
