"""The paper's cost/power model (Sections 2.1, 5.3, 6).

The port's counterpart of ``repro.core.cost``, plain Python.

Two levels:
  * the abstract model — Eq. (1) Δ0 = Δ·u/k̄, Eq. (2) C_node = c_i + c_t·k̄/u
    + c_r(1+k̄/u)/R, and the k̄/u cost figure used throughout Figs. 7-9;
  * the concrete $-and-Watts model of Section 5.3: routers at
    350.4·R − 892.3 $, electrical cables at 0.985 $/Gbps, optical cables at
    7.7432 / 7.9178 $/Gbps (10k / 25k-node cases), 40 Gbps links, SerDes
    power 2.8 W/port — verified to reproduce Tables 4, 5 and 6 exactly
    (power) / to cable-split accuracy (dollars).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "DirectNetworkSpec",
    "CostParams",
    "cost_figure",
    "max_terminals_per_router",
    "cost_per_node_generic",
    "dollars_per_node",
    "watts_per_node",
    "network_summary",
]

LINK_GBPS = 40.0
ELECTRICAL_PER_GBPS = 0.985  # $/Gbps at ~1 m intra-rack average
OPTICAL_PER_GBPS_10K = 7.7432  # $/Gbps, ~10k-node system layout
OPTICAL_PER_GBPS_25K = 7.9178  # $/Gbps, ~25k-node system layout
ROUTER_COST_SLOPE = 350.4  # $/port
ROUTER_COST_OFFSET = -892.3  # $
SERDES_W_PER_PORT = 2.8  # Watts


def max_terminals_per_router(delta: float, u: float, kbar: float) -> float:
    """Eq. (1): Δ0 ≤ Δ·u/k̄ (equality = full bisection, no oversubscription)."""
    return delta * u / kbar


def cost_figure(kbar: float, u: float) -> float:
    """The k̄/u cost measure of Figs. 7 and 9 (port count per node − 1)."""
    return kbar / u


def cost_per_node_generic(radix: float, kbar: float, u: float,
                          c_i: float = 1.0, c_t: float = 1.0, c_r: float = 0.0) -> float:
    """Eq. (2)."""
    return c_i + c_t * kbar / u + c_r * (1 + kbar / u) / radix


@dataclass
class DirectNetworkSpec:
    """A realized network: graph-level parameters + cable layout split."""

    name: str
    terminals: int  # T
    radix: int  # R
    routers: int  # N
    degree: float  # Δ (max degree for the irregular demi-PN)
    terminals_per_router: float  # Δ0
    kbar: float
    u: float
    electrical_cables: int
    optical_cables: int
    indirect: bool = False

    @property
    def subscription(self) -> float:
        """Δ0 / (Δ·u/k̄): 1.0 = exactly full bisection (Tables 4-5 row)."""
        return self.terminals_per_router / max_terminals_per_router(self.degree, self.u, self.kbar)


def dollars_per_node(spec: DirectNetworkSpec, optical_per_gbps: float | None = None) -> float:
    """Section 5.3 installation cost per compute node."""
    if optical_per_gbps is None:
        optical_per_gbps = (OPTICAL_PER_GBPS_10K if spec.terminals < 17500
                            else OPTICAL_PER_GBPS_25K)
    router_cost = spec.routers * (ROUTER_COST_SLOPE * spec.radix + ROUTER_COST_OFFSET)
    cable_cost = (spec.electrical_cables * ELECTRICAL_PER_GBPS * LINK_GBPS
                  + spec.optical_cables * optical_per_gbps * LINK_GBPS)
    return (router_cost + cable_cost) / spec.terminals


def watts_per_node(spec: DirectNetworkSpec) -> float:
    """SerDes power: 2.8 W × total ports / terminals = 2.8·N·R/T."""
    return SERDES_W_PER_PORT * spec.routers * spec.radix / spec.terminals


@dataclass
class CostParams:
    optical_per_gbps: float | None = None


def network_summary(spec: DirectNetworkSpec, params: CostParams = CostParams()) -> dict:
    return {
        "name": spec.name,
        "T": spec.terminals,
        "R": spec.radix,
        "N": spec.routers,
        "delta0": spec.terminals_per_router,
        "kbar": round(spec.kbar, 4),
        "u": round(spec.u, 4),
        "subscription": round(spec.subscription, 3),
        "electrical_cables": spec.electrical_cables,
        "optical_cables": spec.optical_cables,
        "cost_per_node_usd": round(dollars_per_node(spec, params.optical_per_gbps), 2),
        "power_per_node_w": round(watts_per_node(spec), 2),
        "cost_figure_kbar_over_u": round(cost_figure(spec.kbar, spec.u), 4),
    }
