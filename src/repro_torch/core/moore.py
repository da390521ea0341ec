"""Moore and generalized Moore bounds (Section 2.2).  The port's own
copy of ``repro.core.moore`` (numpy only)."""

from __future__ import annotations

import numpy as np

__all__ = [
    "moore_bound",
    "moore_distance_distribution",
    "generalized_moore_distribution",
    "generalized_moore_kbar",
    "min_kbar",
    "kbar_approx",
    "terminals_bound",
]


def moore_bound(delta: int, k: int) -> int:
    """M(Δ, k) = (Δ(Δ-1)^k - 2)/(Δ - 2), Eq. (3)."""
    if delta == 2:
        return 2 * k + 1
    return (delta * (delta - 1) ** k - 2) // (delta - 2)


def moore_distance_distribution(delta: int, k: int) -> np.ndarray:
    w = np.zeros(k + 1, dtype=np.float64)
    w[0] = 1
    for t in range(1, k + 1):
        w[t] = delta * (delta - 1) ** (t - 1)
    return w


def generalized_moore_distribution(delta: int, k: int, n: int) -> np.ndarray:
    """W(t) for a generalized Moore graph on n vertices: Moore-full up to
    k-1, remainder at distance k."""
    if n > moore_bound(delta, k):
        raise ValueError("n exceeds the Moore bound for this (Δ, k)")
    if k >= 1 and n <= moore_bound(delta, k - 1):
        raise ValueError("n fits in diameter k-1; use a smaller k")
    w = moore_distance_distribution(delta, k - 1)
    w = np.append(w, n - w.sum())
    return w


def generalized_moore_kbar(delta: int, k: int, n: int) -> float:
    """Exact minimum average distance for an n-vertex degree-Δ graph."""
    w = generalized_moore_distribution(delta, k, n)
    return float((np.arange(k + 1) * w).sum() / (n - 1))


def min_kbar(delta: int, n: int) -> float:
    """Generalized-Moore lower bound on k̄ for any degree-Δ graph on n vertices."""
    k = 1
    while moore_bound(delta, k) < n:
        k += 1
    return generalized_moore_kbar(delta, k, n)


def kbar_approx(delta: int, k: int, n: int) -> float:
    """Eq. (4): k̄ ≈ k - Δ^(k-1)/N (large-Δ approximation)."""
    return k - delta ** (k - 1) / n


def terminals_bound(radix: int, k: int, kbar: float) -> float:
    """Eq. (5): T ≈ R^k k̄^(k-1) / ((k - k̄)(k̄+1)^k) — the scaling law used
    as the thick lower-bound curve of Fig. 7."""
    if not (0 < kbar < k):
        raise ValueError("need 0 < k̄ < k")
    return radix**k * kbar ** (k - 1) / ((k - kbar) * (kbar + 1) ** k)
