"""Automorphism orbits of the paper's algebraic topologies.

The port's counterpart of ``repro.core.orbits``, numpy on the host.
Every family in Sections 3/4/6 is built from a group action (PGL(3,q) on
the projective plane, F_q-translations on MMS/Paley, coordinate symmetries
on Hamming/hypercube, S_n on MLFM), so a *known subgroup* H <= Aut(G) is
available in closed form — no graph-isomorphism search needed.

Why this accelerates utilization (Theorem 3.9): with L_s the per-arc load
vector of source s under uniform minimal routing, the total T = sum_s L_s
satisfies T(phi(a)) = T(a) for every automorphism phi, i.e. T is constant
on H-arc-orbits.  Moreover sum_{a in O} L_s(a) is constant as s ranges
over an H-vertex-orbit V (phi permutes O), hence

    T(a) = sum_V |V| * (sum_{a' in orbit(a)} L_{rep(V)}(a')) / |orbit(a)|

needs one Brandes sweep per *vertex orbit* instead of per vertex.  For the
vertex-transitive families (PN, demi-PN, MMS, Hamming) that is a single
sweep; OFT has two orbits (leaf columns / spine column) by column symmetry.
The identity holds for any subgroup, so partial generator sets are safe —
they just yield more orbits and less speedup, never wrong loads.

Generators are returned as vertex permutations; ``orbit_info`` validates
each one against the arc structure (a non-automorphism raises), computes
vertex- and arc-orbits by label propagation, and caches them per preserve
mask in the graph's structure cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gf import GF, get_field
from .graph import Graph
from .projective import num_points, normalize_points, point_index, points

__all__ = ["OrbitInfo", "automorphism_generators", "orbit_info"]


@dataclass
class OrbitInfo:
    vertex_orbit: np.ndarray   # (N,)  orbit id per vertex, ids dense from 0
    vertex_reps: np.ndarray    # (n_vorb,) representative vertex per orbit
    vertex_sizes: np.ndarray   # (n_vorb,)
    arc_orbit: np.ndarray      # (A,)  orbit id per directed arc
    arc_sizes: np.ndarray      # (n_aorb,)

    @property
    def n_vertex_orbits(self) -> int:
        return len(self.vertex_reps)


# ---------------------------------------------------------------------------
# GF(q) 3x3 matrix helpers (for the PGL / PGO actions on P2(F_q))
# ---------------------------------------------------------------------------


def _gf_matvec3(f: GF, m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """(..., 3) canonical vectors -> M @ v over GF(q)."""
    out = np.zeros_like(vecs)
    for i in range(3):
        acc = f.mul(m[i, 0], vecs[..., 0])
        acc = f.add(acc, f.mul(m[i, 1], vecs[..., 1]))
        acc = f.add(acc, f.mul(m[i, 2], vecs[..., 2]))
        out[..., i] = acc
    return out


def _gf_mat3_cofactor(f: GF, m: np.ndarray) -> np.ndarray:
    """Cofactor matrix over GF(q); equals det(M) * inv(M)^T for invertible M."""
    c = np.zeros((3, 3), dtype=np.int64)
    for i in range(3):
        for j in range(3):
            r = [k for k in range(3) if k != i]
            s = [k for k in range(3) if k != j]
            ad = f.mul(m[r[0], s[0]], m[r[1], s[1]])
            bc = f.mul(m[r[0], s[1]], m[r[1], s[0]])
            minor = f.sub(ad, bc)
            c[i, j] = minor if (i + j) % 2 == 0 else f.neg(minor)
    return c


def _pgl_point_line_perms(q: int, m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Permutations induced by M in PGL(3,q) on points and on (dual) lines.

    Points map by v -> Mv; line coefficient vectors by w -> M^{-T} w, so
    incidence v.w = 0 is preserved.  M^{-T} is the cofactor matrix up to the
    (projectively irrelevant) det factor.
    """
    f = get_field(q)
    pts = points(q)
    pperm = point_index(q, normalize_points(f, _gf_matvec3(f, m, pts)))
    cof = _gf_mat3_cofactor(f, m)
    lperm = point_index(q, normalize_points(f, _gf_matvec3(f, cof, pts)))
    return pperm, lperm


def _frobenius_point_perm(q: int) -> np.ndarray | None:
    """x -> x^p on coordinates (semilinear; preserves incidence and the dot
    form).  Canonical leading-1 representatives stay canonical."""
    f = get_field(q)
    if f.m == 1:
        return None
    return point_index(q, f.pow(points(q), f.p))


def _orthogonal_generators(q: int) -> list[np.ndarray]:
    """3x3 matrices M with M^T M = I over GF(q): coordinate permutations, a
    sign flip, and one plane rotation per coordinate plane (a^2 + b^2 = 1).
    These commute with the polarity, so they act on demi-PN = ER_q."""
    f = get_field(q)
    eye = np.eye(3, dtype=np.int64)
    cyc = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.int64)
    swap01 = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.int64)
    flip = eye.copy()
    flip[2, 2] = f.neg(1)
    mats = [cyc, swap01, flip]
    # sqrt table: squaring image -> one preimage (covers odd and even char)
    xs = np.arange(q, dtype=np.int64)
    sqrt_tab = np.full(q, -1, dtype=np.int64)
    sqrt_tab[f.mul(xs, xs)] = xs
    found = 0
    for a in range(2, q):
        bsq = f.sub(1, f.mul(a, a))
        b = int(sqrt_tab[bsq])
        if b <= 0:
            continue
        mats.append(np.array([[a, b, 0], [f.neg(b), a, 0], [0, 0, 1]],
                             dtype=np.int64))
        mats.append(np.array([[1, 0, 0], [0, a, b], [0, f.neg(b), a]],
                             dtype=np.int64))
        found += 1
        if found >= 2:
            break
    return mats


# ---------------------------------------------------------------------------
# Per-family vertex-permutation generators
# ---------------------------------------------------------------------------


def _gens_pn(g: Graph) -> list[np.ndarray]:
    q = g.meta["q"]
    n = num_points(q)
    f = get_field(q)
    xi = f.primitive_element()
    mats = [
        np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.int64),   # cycle
        np.array([[1, 1, 0], [0, 1, 0], [0, 0, 1]], dtype=np.int64),   # shear
        np.array([[xi, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.int64),  # scale
    ]
    gens = []
    for m in mats:
        pp, lp = _pgl_point_line_perms(q, m)
        gens.append(np.concatenate([pp, n + lp]))
    frob = _frobenius_point_perm(q)
    if frob is not None:
        gens.append(np.concatenate([frob, n + frob]))
    # duality: the incidence form is symmetric, so point i <-> line i
    idx = np.arange(n)
    gens.append(np.concatenate([n + idx, idx]))
    return gens


def _gens_demi_pn(g: Graph) -> list[np.ndarray]:
    q = g.meta["q"]
    f = get_field(q)
    pts = points(q)
    gens = []
    for m in _orthogonal_generators(q):
        gens.append(point_index(q, normalize_points(f, _gf_matvec3(f, m, pts))))
    frob = _frobenius_point_perm(q)
    if frob is not None:
        gens.append(frob)
    return gens


def _gens_oft(g: Graph) -> list[np.ndarray]:
    q = g.meta["q"]
    n = num_points(q)
    f = get_field(q)
    xi = f.primitive_element()
    mats = [
        np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.int64),
        np.array([[1, 1, 0], [0, 1, 0], [0, 0, 1]], dtype=np.int64),
        np.array([[xi, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.int64),
    ]
    gens = []
    for m in mats:
        pp, lp = _pgl_point_line_perms(q, m)
        gens.append(np.concatenate([pp, n + lp, 2 * n + pp]))
    frob = _frobenius_point_perm(q)
    if frob is not None:
        gens.append(np.concatenate([frob, n + frob, 2 * n + frob]))
    # column reversal 0 <-> 2 (the relation is symmetric in the two leaf cols)
    idx = np.arange(n)
    gens.append(np.concatenate([2 * n + idx, n + idx, idx]))
    return gens


def _gens_mms(g: Graph) -> list[np.ndarray]:
    q = g.meta["q"]
    f = get_field(q)
    qq = q * q
    s = np.repeat(np.arange(2), qq)
    x = np.tile(np.repeat(np.arange(q), q), 2)
    y = np.tile(np.arange(q), 2 * q)
    basis = [int(f.p**i) for i in range(f.m)]  # additive basis of F_q

    def idx(ss, xx, yy):
        return ss * qq + xx * q + yy

    gens = []
    for t in basis:
        # y-translation: (s, x, y) -> (s, x, y + t)
        gens.append(idx(s, x, f.add(y, t)))
        # psi_t: (0,x,y) -> (0, x+t, y);  (1,x,y) -> (1, x, y - t*x)
        x2 = np.where(s == 0, f.add(x, t), x)
        y2 = np.where(s == 0, y, f.sub(y, f.mul(t, x)))
        gens.append(idx(s, x2, y2))
        # phi_t: (1,x,y) -> (1, x+t, y);  (0,x,y) -> (0, x, y + t*x)
        x3 = np.where(s == 1, f.add(x, t), x)
        y3 = np.where(s == 1, y, f.add(y, f.mul(t, x)))
        gens.append(idx(s, x3, y3))
    return gens


def _gens_hamming(g: Graph) -> list[np.ndarray]:
    n, dim = g.meta["side"], g.meta["dim"]
    size = n**dim
    coords = np.stack(np.unravel_index(np.arange(size), (n,) * dim), axis=1)

    def ravel(c):
        return np.ravel_multi_index(tuple(c[:, k] for k in range(dim)), (n,) * dim)

    gens = []
    for d in range(dim):
        c = coords.copy()
        c[:, d] = (c[:, d] + 1) % n  # symbol cycle in coordinate d
        gens.append(ravel(c))
    c = coords.copy()  # symbol transposition 0<->1 in coordinate 0
    c[:, 0] = np.where(c[:, 0] == 0, 1, np.where(c[:, 0] == 1, 0, c[:, 0]))
    gens.append(ravel(c))
    if dim > 1:
        gens.append(ravel(coords[:, np.roll(np.arange(dim), 1)]))  # coord cycle
        c = coords.copy()
        c[:, [0, 1]] = c[:, [1, 0]]
        gens.append(ravel(c))
    return gens


def _gens_hypercube(g: Graph) -> list[np.ndarray]:
    dim = g.meta["dim"]
    v = np.arange(2**dim)
    gens = [v ^ (1 << d) for d in range(dim)]
    if dim > 1:  # swap bits 0 and 1
        b0, b1 = (v >> 0) & 1, (v >> 1) & 1
        gens.append((v & ~np.int64(3)) | (b0 << 1) | b1)
    return gens


def _sym_group_gens(n: int) -> list[np.ndarray]:
    idx = np.arange(n)
    gens = [np.roll(idx, -1)]
    if n > 1:
        t = idx.copy()
        t[[0, 1]] = [1, 0]
        gens.append(t)
    return gens


def _gens_complete(g: Graph) -> list[np.ndarray]:
    return _sym_group_gens(g.n)


def _gens_bipartite(g: Graph) -> list[np.ndarray]:
    n = g.n // 2
    gens = []
    for p in _sym_group_gens(n):
        gens.append(np.concatenate([p, n + np.arange(n)]))
    idx = np.arange(n)
    gens.append(np.concatenate([n + idx, idx]))  # side swap
    return gens


def _gens_paley(g: Graph) -> list[np.ndarray]:
    q = g.meta["q"]
    f = get_field(q)
    x = np.arange(q)
    gens = [f.add(x, int(f.p**i)) for i in range(f.m)]
    xi = f.primitive_element()
    gens.append(f.mul(f.mul(xi, xi), x))  # scaling by a nonzero square
    return gens


def _gens_mlfm(g: Graph) -> list[np.ndarray]:
    n = g.meta["n_mesh"]
    n_leaves = n * (n - 1)
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    pair_id = {ab: n_leaves + s for s, ab in enumerate(pairs)}
    la = np.repeat(np.arange(n), n - 1)
    li = np.tile(np.arange(n - 1), n)
    gens = []
    for sig in _sym_group_gens(n):
        leaf = sig[la] * (n - 1) + li
        spine = np.array([pair_id[tuple(sorted((sig[a], sig[b])))]
                          for a, b in pairs], dtype=np.int64)
        gens.append(np.concatenate([leaf, spine]))
    if n - 1 > 1:  # replica S_{n-1} in column 0 (others follow by conjugation)
        perm = np.arange(g.n)
        perm[[0, 1]] = [1, 0]
        gens.append(perm)
        perm = np.arange(g.n)
        perm[: n - 1] = np.roll(perm[: n - 1], -1)
        gens.append(perm)
    return gens


_FAMILY_GENS = {
    "pn": _gens_pn,
    "demi_pn": _gens_demi_pn,
    "oft": _gens_oft,
    "mms": _gens_mms,
    "hamming": _gens_hamming,
    "hypercube": _gens_hypercube,
    "complete": _gens_complete,
    "bipartite": _gens_bipartite,
    "paley": _gens_paley,
    "mlfm": _gens_mlfm,
}


def automorphism_generators(g: Graph) -> list[np.ndarray] | None:
    """Known automorphism generators for ``g`` (vertex permutations), or
    None when the family has no closed-form group here (turan, dragonfly,
    random, ad-hoc graphs).  Degraded graphs (:mod:`.faults`) keep
    their family meta for traffic-pattern semantics but a fault set
    breaks the symmetry, so they never get the family's generators."""
    if g.meta.get("faults"):
        return None
    fn = _FAMILY_GENS.get(g.meta.get("family"))
    return None if fn is None else fn(g)


# ---------------------------------------------------------------------------
# Orbit computation
# ---------------------------------------------------------------------------


def _arc_permutation(g: Graph, vperm: np.ndarray) -> np.ndarray:
    """Permutation induced on directed arcs; raises if ``vperm`` is not an
    automorphism (an image pair is not an arc)."""
    order, keys = g.arc_sort_by_pair()
    qkeys = vperm[g.arc_src] * np.int64(g.n) + vperm[g.indices]
    pos = np.searchsorted(keys, qkeys)
    if (pos >= len(keys)).any() or (keys[np.minimum(pos, len(keys) - 1)] != qkeys).any():
        raise ValueError("permutation is not a graph automorphism")
    return order[pos]


def _label_components(n: int, perms: list[np.ndarray]) -> np.ndarray:
    """Connected components of x ~ p(x): min-label propagation with pointer
    jumping.  Returns the minimum element of each orbit as its label."""
    lab = np.arange(n, dtype=np.int64)
    inv = []
    for p in perms:
        ip = np.empty_like(p)
        ip[p] = np.arange(n, dtype=np.int64)
        inv.append(ip)
    while True:
        prev = lab
        for p in perms:
            lab = np.minimum(lab, lab[p])
        for ip in inv:
            lab = np.minimum(lab, lab[ip])
        lab = np.minimum(lab, lab[lab])
        lab = np.minimum(lab, lab[lab])
        if np.array_equal(lab, prev):
            return lab


def orbit_info(g: Graph, preserve_mask: np.ndarray | None = None) -> OrbitInfo | None:
    """Vertex/arc orbits of the known automorphism subgroup of ``g``.

    When ``preserve_mask`` is given, only generators that fix the mask
    set-wise are used (needed for leaf-restricted traffic, Section 6); the
    result is cached per mask in the graph's structure cache.
    """
    key = None if preserve_mask is None else preserve_mask.tobytes()
    return g._struct(("orbits", key), lambda: _orbit_info(g, preserve_mask))


def _orbit_info(g: Graph,
                preserve_mask: np.ndarray | None) -> OrbitInfo | None:
    gens = automorphism_generators(g)
    if gens and preserve_mask is not None:
        gens = [p for p in gens
                if np.array_equal(preserve_mask[p], preserve_mask)]
    if not gens:
        return None
    arc_perms = [_arc_permutation(g, p) for p in gens]
    vlab = _label_components(g.n, gens)
    alab = _label_components(len(g.arc_src), arc_perms)
    vreps, vorb = np.unique(vlab, return_inverse=True)
    _, aorb = np.unique(alab, return_inverse=True)
    return OrbitInfo(
        vertex_orbit=vorb,
        vertex_reps=vreps,
        vertex_sizes=np.bincount(vorb),
        arc_orbit=aorb,
        arc_sizes=np.bincount(aorb),
    )
