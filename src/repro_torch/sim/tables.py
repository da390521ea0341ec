"""Precomputed routing structure for the flow-level simulator.

The port's counterpart of ``repro.sim.tables``: everything that depends
only on the topology — shortest-path next-hop splits, delivery masks,
the Valiant intermediate spread, remaining-hop estimates for the UGAL
rule — compiled once per ``(graph, active)`` pair into tensors on the
run's device, laid out over ``(router, out-slot, dest)``:

  * out-slot ``k`` of router ``r`` is directed arc ``indptr[r] + k``;
  * the dest axis is restricted to the ``active`` set (all routers, or
    the leaf set of an indirect network).

``SPLIT[r, k, d]`` is the fraction of fluid at ``r`` headed for active
dest ``d`` that leaves through slot ``k`` under equal-split minimal
routing: ``1/m`` over the ``m`` out-arcs on a shortest path, 0
elsewhere.  The tables equal the reference's exactly (the tests compare
them element for element), pristine and faulted: ``build_tables(faults=)``
compiles them for a degraded fabric in the pristine ``(N, K)`` layout,
so that fluid state carries across a mid-run fault event
(:mod:`repro_torch.sim.faults`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..core.graph import Graph, bfs_distances_batched

__all__ = ["RouteTables", "build_tables"]


@dataclass
class RouteTables:
    """Topology-dependent constants of one simulator instance, as tensors
    on one device.  Shapes: N routers, K = max degree (padded out-slots),
    M active dests.

    The mask block describes the degraded fabric the tables were
    compiled for (``build_tables(faults=...)``): live out-slots, live
    routers, live destinations and the (router, dest) pairs that are
    still connected.  On pristine tables every mask is all-alive (but the
    padded slots) and ``faulted`` is False."""

    n: int
    k: int
    m: int
    active: torch.Tensor                         # (M,) int64 router ids
    head: torch.Tensor = field(repr=False)       # (N, K) int64, pad = N
    split: torch.Tensor = field(repr=False)      # (N, K, M) ECMP split
    deliver: torch.Tensor = field(repr=False)    # (N, K, M) bool
    spread: torch.Tensor = field(repr=False)     # (N, M) Valiant mids
    dist_act: torch.Tensor = field(repr=False)   # (N, M) hops to dests
    hval_rem: torch.Tensor = field(repr=False)   # (N, M) two-leg estimate
    slot_ok: torch.Tensor = field(repr=False, default=None)    # (N, K)
    router_ok: torch.Tensor = field(repr=False, default=None)  # (N,)
    dest_ok: torch.Tensor = field(repr=False, default=None)    # (M,)
    routable: torch.Tensor = field(repr=False, default=None)   # (N, M)
    faulted: bool = False

    @property
    def device(self) -> torch.device:
        return self.split.device


def slot_heads(g: Graph) -> np.ndarray:
    """(N, K) int64 head router of every out-slot, N on padded slots."""
    n, k = g.n, g.max_degree
    head = np.full((n, k), n, dtype=np.int64)
    slot = np.arange(len(g.indices)) - g.indptr[g.arc_src]
    head[g.arc_src, slot] = g.indices
    return head


def build_tables(g: Graph, active, dtype=torch.float64, faults=None,
                 device=None) -> RouteTables:
    """Compile the routing tables for ``g`` restricted to ``active``
    destinations: one batched all-source BFS plus O(N * K * M) table
    fills on ``device``.

    With ``faults`` (a :class:`repro_torch.core.faults.FaultSet`) the
    tables are compiled for the degraded fabric while KEEPING the
    pristine ``(N, K)`` layout: dead routers and dead out-slots stay
    addressable but are masked out of every split and spread and flagged
    in ``slot_ok`` / ``routable``.  Distances and ECMP splits are
    recomputed on the surviving graph (per-hop ECMP through the masked
    splits is the reroute); unreachable entries get the sentinel and are
    zeroed in ``dist_act`` and ``hval_rem``."""
    device = resolve_device(device)
    active_np = np.asarray(active, dtype=np.int64)
    n, m = g.n, len(active_np)
    if m < 2:
        raise ValueError("need at least 2 active vertices")
    k = g.max_degree
    sent = np.iinfo(np.int32).max // 2   # unreachable / padded-slot marker

    faulted = faults is not None and not faults.empty
    if faulted:
        edge_alive = faults.edge_alive(g)
        router_ok_np = faults.router_mask(g)
        dist = bfs_distances_batched(g.subgraph(edge_mask=edge_alive),
                                     np.arange(n), device=device)
        dist[dist < 0] = sent
    else:
        edge_alive = np.ones(g.num_edges, dtype=bool)
        router_ok_np = np.ones(n, dtype=bool)
        dist = bfs_distances_batched(g, np.arange(n), device=device)
        if bool((dist < 0).any()):
            raise ValueError("graph is disconnected")
    act = torch.as_tensor(active_np, device=device)
    head_np = slot_heads(g)
    head = torch.as_tensor(head_np, device=device)
    slot_ok_np = np.zeros((n, k), dtype=bool)
    slot = np.arange(len(g.indices)) - g.indptr[g.arc_src]
    slot_ok_np[g.arc_src, slot] = edge_alive[g.arc_edge_id]
    slot_ok = torch.as_tensor(slot_ok_np, device=device)
    router_ok = torch.as_tensor(router_ok_np, device=device)
    dest_ok = router_ok[act]
    dist_act = dist[:, act]                                  # (N, M)
    routable = router_ok[:, None] & dest_ok[None, :] & (dist_act < sent)
    if faulted:
        if int(dest_ok.sum()) < 2:
            raise ValueError("fewer than 2 active destinations survive "
                             "the faults")
        alive_ids = torch.nonzero(dest_ok).reshape(-1)
        if not bool(routable[act[dest_ok]][:, alive_ids].all()):
            raise ValueError(
                "faults disconnect the active set: surviving active "
                "vertices are not mutually reachable")

    # dist from each slot's head router to each active dest; padded and
    # dead slots never look like a next hop
    dist_pad = torch.cat([dist[:, act],
                          torch.full((1, m), sent, dtype=dist.dtype,
                                     device=device)])
    head_dist = dist_pad[head]                               # (N, K, M)
    min_mask = ((head_dist == (dist_act[:, None, :] - 1))
                & slot_ok[:, :, None])
    del head_dist
    count = min_mask.sum(dim=1)                              # (N, M)
    split = (min_mask.to(torch.float64)
             / count.clamp(min=1).to(torch.float64)[:, None, :]).to(dtype)
    del min_mask

    deliver = head[:, :, None] == act[None, None, :]
    # Valiant intermediate spread: uniform over the surviving active mids
    # this router can reach, other than itself, normalized per row
    not_self = act[None, :] != torch.arange(n, device=device)[:, None]
    ok_mid = not_self & routable
    spread = (ok_mid.to(torch.float64)
              / ok_mid.sum(dim=1, keepdim=True).clamp(min=1)
              .to(torch.float64)).to(dtype)

    # remaining-hop estimates for the per-hop UGAL rule: minimal is the
    # true distance; the Valiant detour from r to d is the mean over
    # surviving intermediates of dist(r, m) + dist(m, d).  Integer sums
    # are exact in float64 (sentinels included), so these means equal
    # numpy's bit for bit.
    alive_act = act[dest_ok]
    mean_to_mid = dist[:, alive_act].to(torch.float64).mean(dim=1)
    mean_from_mid = dist[alive_act][:, act].to(torch.float64).mean(dim=0)
    hval_rem = (mean_to_mid[:, None] + mean_from_mid[None, :]).to(dtype)
    dist_out = dist_act.to(dtype)
    if faulted:
        # unroutable pairs never carry fluid, and default_steps and the
        # UGAL inequality must not read the sentinel as a distance
        zero = torch.zeros((), dtype=dtype, device=device)
        dist_out = torch.where(routable, dist_out, zero)
        hval_rem = torch.where(routable, hval_rem, zero)

    return RouteTables(
        n=n, k=k, m=m, active=act, head=head, split=split,
        deliver=deliver, spread=spread, dist_act=dist_out,
        hval_rem=hval_rem, slot_ok=slot_ok, router_ok=router_ok,
        dest_ok=dest_ok, routable=routable, faulted=faulted)
