"""Finite-field arithmetic GF(q) for q = p^m, vectorized over numpy arrays.

The port's own copy of ``repro.core.gf`` (numpy only, unchanged in
behaviour), so that ``repro_torch`` imports nothing of ``repro``.

Elements of GF(p^m) are encoded as integers in [0, q): the integer's base-p
digits are the coefficients of the element's polynomial representation over
GF(p).  Multiplication uses discrete log/antilog tables built from a
primitive polynomial found by exhaustive search (cheap for the q used by the
paper's constructions, q <= ~1024).

The tables make every field op a numpy gather, so constructing the incidence
structures of Section 3 stays vectorized end to end.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

__all__ = ["GF", "is_prime", "is_prime_power", "prime_power_decompose"]


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def prime_power_decompose(q: int) -> tuple[int, int] | None:
    """Return (p, m) with q == p**m and p prime, or None."""
    if q < 2:
        return None
    for p in range(2, q + 1):
        if p * p > q:
            break
        if q % p:
            continue
        m, r = 0, q
        while r % p == 0:
            r //= p
            m += 1
        return (p, m) if r == 1 and is_prime(p) else None
    return (q, 1) if is_prime(q) else None


def is_prime_power(q: int) -> bool:
    return prime_power_decompose(q) is not None


def _poly_mul_mod(a: np.ndarray, b: np.ndarray, mod_poly: np.ndarray, p: int) -> np.ndarray:
    """Multiply two polynomials over GF(p) and reduce by the monic mod_poly."""
    m = len(mod_poly) - 1
    prod = np.zeros(len(a) + len(b) - 1, dtype=np.int64)
    for i, ai in enumerate(a):
        if ai:
            prod[i : i + len(b)] = (prod[i : i + len(b)] + ai * b) % p
    # Reduce: mod_poly is monic of degree m.
    for d in range(len(prod) - 1, m - 1, -1):
        c = prod[d]
        if c:
            prod[d - m : d + 1] = (prod[d - m : d + 1] - c * mod_poly) % p
    return prod[:m] % p


def _int_to_poly(x: int, p: int, m: int) -> np.ndarray:
    out = np.zeros(m, dtype=np.int64)
    for i in range(m):
        out[i] = x % p
        x //= p
    return out


def _poly_to_int(c: np.ndarray, p: int) -> int:
    v = 0
    for coeff in reversed(c.tolist()):
        v = v * p + int(coeff)
    return v


def _find_primitive_poly(p: int, m: int) -> np.ndarray:
    """Exhaustively find a monic primitive polynomial of degree m over GF(p).

    Primitivity is checked directly: x must generate all q-1 nonzero elements
    of GF(p)[x]/(f).  O(q^2) worst case; fine for q <= ~2048.
    """
    q = p**m
    x_poly = np.zeros(m, dtype=np.int64)
    if m == 1:
        x_poly[0] = 1  # placeholder, unused for m == 1
    else:
        x_poly[1] = 1
    for tail in range(p**m):
        mod_poly = np.zeros(m + 1, dtype=np.int64)
        mod_poly[m] = 1
        mod_poly[:m] = _int_to_poly(tail, p, m)
        if mod_poly[0] == 0:  # constant term 0 => divisible by x
            continue
        # Walk powers of x; primitive iff the orbit has size q-1.
        seen = 1
        cur = x_poly.copy()
        start = _poly_to_int(cur, p)
        ok = True
        for _ in range(q - 2):
            cur = _poly_mul_mod(cur, x_poly, mod_poly, p)
            v = _poly_to_int(cur, p)
            if v == start or v == 0:
                ok = False
                break
            seen += 1
        if ok and seen == q - 1:
            # cur is now x^(q-1); primitive iff it equals 1.
            if _poly_to_int(cur, p) == 1:
                return mod_poly
    raise ValueError(f"no primitive polynomial found for GF({p}^{m})")


@dataclass
class GF:
    """The finite field GF(q), q = p^m, with vectorized numpy arithmetic."""

    q: int
    p: int = field(init=False)
    m: int = field(init=False)
    exp: np.ndarray = field(init=False, repr=False)  # exp[i] = g^i, len 2(q-1)
    log: np.ndarray = field(init=False, repr=False)  # log[x] for x in 1..q-1
    _neg: np.ndarray = field(init=False, repr=False)
    _inv: np.ndarray = field(init=False, repr=False)
    _add_hi: np.ndarray = field(init=False, repr=False)  # add table, q x q (small q)

    def __post_init__(self) -> None:
        pm = prime_power_decompose(self.q)
        if pm is None:
            raise ValueError(f"q={self.q} is not a prime power")
        self.p, self.m = pm
        p, m, q = self.p, self.m, self.q
        if m == 1:
            # Prime field: addition is mod-p; find multiplicative generator.
            g = self._find_generator_prime(p)
            exp = np.empty(max(2 * (q - 1), 1), dtype=np.int64)
            cur = 1
            for i in range(q - 1):
                exp[i] = cur
                cur = (cur * g) % p
            exp[q - 1 : 2 * (q - 1)] = exp[: q - 1]
            self.exp = exp
            log = np.zeros(q, dtype=np.int64)
            log[exp[: q - 1]] = np.arange(q - 1)
            self.log = log
            self._neg = (-np.arange(q)) % p
            self._add_hi = np.add.outer(np.arange(q), np.arange(q)) % p
        else:
            mod_poly = _find_primitive_poly(p, m)
            # exp table via repeated multiplication by x.
            exp = np.empty(2 * (q - 1), dtype=np.int64)
            cur = np.zeros(m, dtype=np.int64)
            cur[0] = 1  # the element 1
            x_poly = np.zeros(m, dtype=np.int64)
            x_poly[1] = 1
            for i in range(q - 1):
                exp[i] = _poly_to_int(cur, p)
                cur = _poly_mul_mod(cur, x_poly, mod_poly, p)
            exp[q - 1 :] = exp[: q - 1]
            self.exp = exp
            log = np.zeros(q, dtype=np.int64)
            log[exp[: q - 1]] = np.arange(q - 1)
            self.log = log
            # Addition: digitwise mod-p.  Precompute full table (q<=1024 ok).
            a = np.arange(q)
            digits_a = np.stack([(a // p**i) % p for i in range(m)], axis=-1)
            s = (digits_a[:, None, :] + digits_a[None, :, :]) % p
            weights = p ** np.arange(m)
            self._add_hi = (s * weights).sum(axis=-1)
            self._neg = ((-digits_a) % p * weights).sum(axis=-1)
        # Inverse table.
        inv = np.zeros(q, dtype=np.int64)
        nz = np.arange(1, q)
        inv[nz] = self.exp[(q - 1) - self.log[nz]]
        self._inv = inv

    @staticmethod
    def _find_generator_prime(p: int) -> int:
        if p == 2:
            return 1
        # factor p-1
        n = p - 1
        factors = []
        d = 2
        while d * d <= n:
            if n % d == 0:
                factors.append(d)
                while n % d == 0:
                    n //= d
            d += 1
        if n > 1:
            factors.append(n)
        for g in range(2, p):
            if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
                return g
        raise ValueError("no generator")

    # -- vectorized ops (accept ints or numpy arrays, return int64 arrays) --
    def add(self, a, b):
        return self._add_hi[np.asarray(a), np.asarray(b)]

    def neg(self, a):
        return self._neg[np.asarray(a)]

    def sub(self, a, b):
        return self._add_hi[np.asarray(a), self._neg[np.asarray(b)]]

    def mul(self, a, b):
        a = np.asarray(a)
        b = np.asarray(b)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF(q)")
        return self._inv[a]

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow(self, a, k: int):
        a = np.asarray(a)
        if k == 0:
            return np.ones_like(a)
        out = self.exp[(self.log[a] * (k % (self.q - 1))) % (self.q - 1)]
        return np.where(a == 0, 0, out)

    def primitive_element(self) -> int:
        return int(self.exp[1]) if self.q > 2 else 1

    def squares(self) -> np.ndarray:
        """The set of nonzero squares of GF(q)."""
        e = np.arange(0, self.q - 1, 2)
        return np.unique(self.exp[e])

    def dot3(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Scalar product of 3-vectors over GF(q); u, v shaped (..., 3)."""
        t0 = self.mul(u[..., 0], v[..., 0])
        t1 = self.mul(u[..., 1], v[..., 1])
        t2 = self.mul(u[..., 2], v[..., 2])
        return self.add(self.add(t0, t1), t2)


@functools.lru_cache(maxsize=None)
def get_field(q: int) -> GF:
    return GF(q)
