"""McKay–Miller–Širáň graphs (the Slim Fly topology of [2]), per Section 4.2.

The port's own copy of ``repro.core.mms`` (numpy only).

Vertices (s, x, y), s in {0,1}, x,y in F_q; index = s*q^2 + x*q + y.
Local edges:  (s,x,y1) ~ (s,x,y2)   iff y1 - y2 in X_s,
Global edges: (0,x1,y1) ~ (1,x2,y2) iff y1 - y2 = x2 * x1,
with X_0 the (epsilon-adjusted) even powers of a primitive element and
X_1 = xi * X_0.  Degree (3q - eps)/2, diameter 2, N = 2 q^2.
"""

from __future__ import annotations

import numpy as np

from .gf import get_field, prime_power_decompose
from .graph import Graph

__all__ = ["mms_graph", "mms_eps", "mms_generator_sets"]


def mms_eps(q: int) -> int:
    r = q % 4
    if r == 1:
        return 1
    if r == 3:
        return -1
    if r == 0:
        return 0
    raise ValueError(f"q={q}: q ≡ 2 (mod 4) has no MMS graph (q must be a prime power != 2)")


def mms_generator_sets(q: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Return (X0, X1, eps) per the paper's case split on eps."""
    f = get_field(q)
    eps = mms_eps(q)
    xi = f.primitive_element()
    powers = f.exp[: q - 1]  # xi^0 .. xi^(q-2)
    if eps == 1:
        x0 = powers[0 : q - 2 : 2]  # 1, xi^2, ..., xi^(q-3)
    elif eps == -1:
        # ± even powers: exponents {0,2,..,(q-3)/2} ∪ {(q-1)/2,(q-1)/2+2,..,q-2},
        # the closed-under-negation set with X0 ∩ xi*X0 = {1,-1} the paper needs.
        idx = list(range(0, (q - 1) // 2, 2)) + list(range((q - 1) // 2, q - 1, 2))
        x0 = powers[np.array(idx, dtype=np.int64)]
    else:  # eps == 0 (q a power of 2)
        x0 = powers[0 : q - 1 : 2]  # 1, xi^2, ..., xi^(q-2)
    x1 = f.mul(xi, x0)
    assert len(x0) == (q - eps) // 2, (len(x0), q, eps)
    union = set(x0.tolist()) | set(x1.tolist())
    assert union == set(range(1, q)), "X0 ∪ X1 must be F_q \\ {0}"
    return np.asarray(x0), np.asarray(x1), eps


def mms_graph(q: int) -> Graph:
    """Slim Fly MMS(q) for q a prime power, q != 2."""
    if prime_power_decompose(q) is None:
        raise ValueError(f"q={q} must be a prime power")
    f = get_field(q)
    x0, x1, eps = mms_generator_sets(q)
    qq = q * q
    edges = []

    # Local edges: within column (s, x), connect y1 ~ y2 when y1 - y2 in X_s.
    ys = np.arange(q, dtype=np.int64)
    diff = f.sub(ys[:, None], ys[None, :])  # (q, q)
    for s, xset in ((0, x0), (1, x1)):
        mask = np.isin(diff, xset)
        y1, y2 = np.nonzero(mask)
        keep = y1 < y2  # X_s is symmetric (xi^(q-1)/2 = -1 cases handled by defn)
        y1, y2 = y1[keep], y2[keep]
        for x in range(q):
            base = s * qq + x * q
            edges.append(np.stack([base + y1, base + y2], axis=1))

    # Global edges: (0,x1,y1) ~ (1,x2,y2) iff y1 - y2 = x2*x1.
    xs = np.arange(q, dtype=np.int64)
    x1g, x2g = np.meshgrid(xs, xs, indexing="ij")
    prod = f.mul(x2g.ravel(), x1g.ravel())  # (q*q,)
    y1g = np.repeat(ys[None, :], q * q, axis=0)  # for each (x1,x2), all y1
    y2g = f.sub(y1g, prod[:, None])
    src = (x1g.ravel()[:, None] * q + y1g).ravel()
    dst = (qq + x2g.ravel()[:, None] * q + y2g).ravel()
    edges.append(np.stack([src, dst], axis=1))

    g = Graph(2 * qq, np.concatenate(edges), name=f"SF-MMS({q})")
    n_local = int(sum(e.shape[0] for e in edges[:-1]))
    g.meta.update(q=q, eps=eps, family="mms", n_local_edges=n_local,
                  n_global_edges=int(edges[-1].shape[0]))
    return g
