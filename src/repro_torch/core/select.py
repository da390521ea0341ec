"""Closed-form realizations of every Table-2/3 family + the Section-5
optimal-topology selector: given a router radix budget and a terminal
target, enumerate feasible networks and rank them by the k̄/u cost figure.

The port's counterpart of ``repro.core.select``, plain Python.

Formulas follow Tables 2 and 3 exactly; where the paper uses limit values
(Turán, Delorme, generalized quadrangle/hexagon incidence) we do too, and
where exact k̄/u are cheap (PN, demi-PN, Hamming, hypercube, complete,
bipartite) we use the exact expressions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .gf import is_prime_power
from .moore import min_kbar

__all__ = ["Realization", "realizations_for_family", "all_realizations",
           "select_topology", "FAMILIES"]


@dataclass
class Realization:
    family: str
    param: int  # q, n, h, r ... primary size parameter
    terminals: float
    radix: float
    routers: float
    degree: float
    delta0: float
    kbar: float
    u: float
    diameter: int
    extra: dict = field(default_factory=dict)

    @property
    def cost_figure(self) -> float:
        return self.kbar / self.u


def _mk(family, param, N, delta, kbar, u, k, **extra) -> Realization:
    delta0 = delta * u / kbar
    return Realization(family=family, param=param, terminals=N * delta0,
                       radix=delta + delta0, routers=N, degree=delta,
                       delta0=delta0, kbar=kbar, u=u, diameter=k, extra=extra)


def _complete(n):  # K_N
    return _mk("complete", n, n, n - 1, 1.0, 1.0, 1)


def _turan(n, r):
    if n % r:
        return None
    kbar = 1 + (n / r - 1) / (n - 1)
    return _mk("turan", n, n, n - n / r, kbar, 1.0, 2, r=r)


def _bipartite(n):  # K_{n,n}
    kbar = (n + 2 * (n - 1)) / (2 * n - 1)
    return _mk("bipartite", n, 2 * n, n, kbar, 1.0, 2)


def _hamming2(n):
    kbar = 2 * n / (n + 1)
    return _mk("hamming2", n, n * n, 2 * (n - 1), kbar, 1.0, 2, side=n)


def _hamming3(n):
    # W: 3(n-1) at 1, 3(n-1)^2 at 2, (n-1)^3 at 3
    N = n**3
    kbar = (3 * (n - 1) + 6 * (n - 1) ** 2 + 3 * (n - 1) ** 3) / (N - 1)
    return _mk("hamming3", n, N, 3 * (n - 1), kbar, 1.0, 3, side=n)


def _demi_pn(q):
    if not is_prime_power(q):
        return None
    N = q * q + q + 1
    kbar = 2 - (q + 1) / N
    u = (2 * q * q + q + 1) / (2 * q * (q + 1))
    return _mk("demi_pn", q, N, q + 1, kbar, u, 2)


def _pn(q):
    if not is_prime_power(q):
        return None
    N = 2 * (q * q + q + 1)
    kbar = (5 * q * q + 3 * q + 1) / (2 * q * q + 2 * q + 1)
    return _mk("pn", q, N, q + 1, kbar, 1.0, 3)


def _mms(q):
    if not is_prime_power(q) or q % 4 == 2 or q == 2:
        return None
    eps = {1: 1, 3: -1, 0: 0}[q % 4]
    N = 2 * q * q
    delta = (3 * q - eps) / 2
    kbar = 2 - delta / (N - 1)
    return _mk("mms", q, N, delta, kbar, 8 / 9, 2, eps=eps)


def _dragonfly(h):
    N = 4 * h**3 + 2 * h
    delta = 3 * h - 1
    # paper's Table 3 dimensioning: Δ0 = h, i.e. effective k̄/u = Δ/h
    r = _mk("dragonfly", h, N, delta, 3.0, 1.0, 3)
    r.delta0 = h
    r.terminals = N * h
    r.radix = 4 * h - 1
    return r


def _delorme_q(q):  # Delorme's graph on generalized quadrangles (k̄ → 3)
    # exists for q an odd power of 2
    m = int(round(np.log2(q)))
    if 2**m != q or m % 2 == 0:
        return None
    N = q**3 + q**2 + q + 1
    return _mk("delorme_q", q, N, q + 1, 3.0, 1.0, 3)


def _gq_incidence(q):  # incidence graph of generalized quadrangles (k̄ → 3.5)
    if not is_prime_power(q):
        return None
    N = 2 * (q**3 + q**2 + q + 1)
    return _mk("gq_incidence", q, N, q + 1, 3.5, 1.0, 4)


def _delorme_h(q):  # Delorme on generalized hexagons (k̄ → 5)
    m = int(round(np.log2(q)))
    if 2**m != q or m % 2 == 0:
        return None
    N = q**5 + q**4 + q**3 + q**2 + q + 1
    return _mk("delorme_h", q, N, q + 1, 5.0, 1.0, 5)


def _gh_incidence(q):  # incidence graph of generalized hexagons (k̄ → 5.5)
    if not is_prime_power(q):
        return None
    N = 2 * (q**5 + q**4 + q**3 + q**2 + q + 1)
    return _mk("gh_incidence", q, N, q + 1, 5.5, 1.0, 6)


def _hypercube(n):
    N = 2**n
    kbar = n * 2 ** (n - 1) / (N - 1)
    return _mk("hypercube", n, N, n, kbar, 1.0, n)


def _random(n_log2, delta):
    N = 2**n_log2
    kbar = max(np.log(N) / np.log(delta), 1.0)
    return _mk("random", N, N, delta, kbar, 0.8, int(np.ceil(kbar)), d=delta)


FAMILIES = {
    "complete": ("n", _complete),
    "turan": ("n", None),  # handled specially (two params)
    "bipartite": ("n", _bipartite),
    "hamming2": ("n", _hamming2),
    "hamming3": ("n", _hamming3),
    "demi_pn": ("q", _demi_pn),
    "pn": ("q", _pn),
    "mms": ("q", _mms),
    "dragonfly": ("h", _dragonfly),
    "delorme_q": ("q", _delorme_q),
    "gq_incidence": ("q", _gq_incidence),
    "delorme_h": ("q", _delorme_h),
    "gh_incidence": ("q", _gh_incidence),
    "hypercube": ("n", _hypercube),
}


def realizations_for_family(family: str, max_radix: int,
                            turan_r: int = 3) -> list[Realization]:
    out: list[Realization] = []
    if family == "turan":
        for n in range(turan_r, 4 * max_radix):
            r = _turan(n, turan_r)
            if r and r.radix <= max_radix:
                out.append(r)
        return out
    _, fn = FAMILIES[family]
    if family == "random":
        fn = _random
    for p in range(2, 6 * max_radix):
        r = fn(p)
        if r is None:
            continue
        if r.radix > max_radix:
            if family in ("hypercube",):  # monotone in param
                break
            if p > 3 * max_radix:
                break
            continue
        out.append(r)
    return out


def all_realizations(max_radix: int) -> dict[str, list[Realization]]:
    return {fam: realizations_for_family(fam, max_radix) for fam in FAMILIES
            if fam != "turan"} | {"turan": realizations_for_family("turan", max_radix)}


def select_topology(terminals: int, max_radix: int,
                    slack: float = 1.0) -> list[Realization]:
    """Feasible realizations with T >= terminals·slack, sorted by k̄/u then
    by router count — the Section-5 'optimal topology is the curve
    immediately above the (R, T) point' rule."""
    cands = [r for fam in all_realizations(max_radix).values() for r in fam
             if r.terminals >= terminals * slack]
    return sorted(cands, key=lambda r: (r.cost_figure, r.routers))
