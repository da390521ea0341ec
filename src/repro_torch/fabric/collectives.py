"""Collective-time estimation on a fabric, grounded in the paper's
saturation model.

A reduce-scatter / all-gather / all-to-all of uniformly-spread data IS the
paper's uniform traffic pattern, so its duration at saturation is

    t = bytes_sent_per_node / node_uniform_bw,
    node_uniform_bw = (Δ · u / k̄) · link_bw / Δ0          (Eq. 1)

— i.e. the k̄/u cost figure directly multiplies collective time.  All-reduce
is reduce-scatter + all-gather.  A latency term (hops × per-hop latency)
covers the small-message regime.

Every entry point takes an optional ``pattern`` (any
repro_torch.core.traffic spec, e.g. ``"hot_region(0.2,4)"`` or
``"collective(ring-all-reduce)"``) and ``routing`` (any
repro_torch.core.routing model: "minimal", "valiant", "ugal",
"ugal(source)"): the saturation throughput of that pattern under that
routing then replaces Eq. 1's uniform Δ·u/k̄ and its demand-weighted hop
count replaces k̄ in the latency term.  Such a pattern is routed on the
fabric's own device (:class:`repro_torch.fabric.model.FabricModel`).

The port's counterpart of ``repro.fabric.collectives``: the same
arithmetic, line for line.
"""

from __future__ import annotations

from dataclasses import dataclass

from .model import FabricModel

__all__ = ["CollectiveCost", "collective_time", "allreduce_time",
           "allgather_time", "alltoall_time", "reducescatter_time",
           "bytes_on_wire", "RING_OPS", "SPREAD_OPS"]

PER_HOP_LATENCY_S = 0.5e-6

# Collectives whose schedule serializes over ring neighbours vs. spreading
# uniformly over the group (MoE dispatch / personalized exchange).
RING_OPS = ("all-reduce", "all-gather", "reduce-scatter")
SPREAD_OPS = ("all-to-all", "collective-permute")

# Bytes each rank puts on the wire per unit payload, relative to the
# (n-1)/n baseline every timer below prices: all-reduce is rs + ag.
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def bytes_on_wire(op: str, bytes_amount: float, n: int) -> float:
    """Bytes ONE rank sends for one ``op`` on an ``n``-rank group — the
    single source of truth for the (n-1)/n byte accounting the timers
    below price and the placement demand pipeline aggregates
    (fabric.placement.placement_demand)."""
    if op not in _WIRE_FACTOR:
        raise ValueError(f"unknown collective {op!r}; "
                         f"options: {RING_OPS + SPREAD_OPS}")
    if n <= 1:
        return 0.0
    return _WIRE_FACTOR[op] * bytes_amount * (n - 1) / n


@dataclass
class CollectiveCost:
    op: str
    bytes_per_node: float
    bandwidth_s: float
    latency_s: float

    @property
    def total_s(self) -> float:
        return self.bandwidth_s + self.latency_s


def _node_bw(fabric: FabricModel, pattern, routing: str) -> float:
    if pattern is None:
        return fabric.node_uniform_bw
    return fabric.pattern_node_bw(pattern, routing)


def _hops(fabric: FabricModel, pattern, routing: str) -> float:
    if pattern is None:
        return fabric.kbar
    return fabric.pattern_kbar(pattern, routing)


def allgather_time(fabric: FabricModel, bytes_global: float, n: int,
                   pattern=None, routing: str = "minimal") -> CollectiveCost:
    """Each node ends with bytes_global; sends its 1/n shard to n-1 peers
    (uniform destinations)."""
    sent = bytes_on_wire("all-gather", bytes_global, n)
    return CollectiveCost("all-gather", bytes_global / n,
                          sent / _node_bw(fabric, pattern, routing),
                          _hops(fabric, pattern, routing) * PER_HOP_LATENCY_S)


def reducescatter_time(fabric: FabricModel, bytes_global: float, n: int,
                       pattern=None, routing: str = "minimal") -> CollectiveCost:
    sent = bytes_on_wire("reduce-scatter", bytes_global, n)
    return CollectiveCost("reduce-scatter", bytes_global / n,
                          sent / _node_bw(fabric, pattern, routing),
                          _hops(fabric, pattern, routing) * PER_HOP_LATENCY_S)


def allreduce_time(fabric: FabricModel, bytes_global: float, n: int,
                   pattern=None, routing: str = "minimal") -> CollectiveCost:
    rs = reducescatter_time(fabric, bytes_global, n, pattern, routing)
    ag = allgather_time(fabric, bytes_global, n, pattern, routing)
    return CollectiveCost("all-reduce", bytes_global,
                          rs.bandwidth_s + ag.bandwidth_s,
                          rs.latency_s + ag.latency_s)


def alltoall_time(fabric: FabricModel, bytes_per_node: float, n: int,
                  pattern=None, routing: str = "minimal") -> CollectiveCost:
    """Personalized all-to-all: the exact uniform-traffic pattern."""
    sent = bytes_on_wire("all-to-all", bytes_per_node, n)
    return CollectiveCost("all-to-all", bytes_per_node,
                          sent / _node_bw(fabric, pattern, routing),
                          _hops(fabric, pattern, routing) * PER_HOP_LATENCY_S)


def collective_time(fabric: FabricModel, op: str, bytes_amount: float,
                    n: int, pattern=None, routing: str = "minimal") -> CollectiveCost:
    fn = {"all-reduce": allreduce_time, "all-gather": allgather_time,
          "reduce-scatter": reducescatter_time, "all-to-all": alltoall_time,
          "collective-permute": alltoall_time}[op]
    return fn(fabric, bytes_amount, n, pattern, routing)
