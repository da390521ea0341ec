"""Carry topology, fault sets, placements, route tables, fluid state,
model weights and serve caches across from plain arrays.

The reference package builds graphs the port has no constructor for yet
(placement graphs) and keeps its fault sets, placements, tables, state,
weights and caches as plain values and arrays.  These helpers build the
port's objects from such values (and caches back), so both packages compute
the same thing on the same inputs.  They take arrays and tuples, never
objects of the reference, and import nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .configs.base import ArchConfig
from .core.faults import FaultSet
from .core.graph import Graph
from .fabric.placement import Placement
from .models.model import build
from .models.transformer import Model, layer_plan, layers_of
from .sim.engine import SimState
from .sim.tables import RouteTables

__all__ = ["graph_from_arrays", "fault_set_from_arrays",
           "placement_from_arrays",
           "tables_from_numpy", "state_from_numpy",
           "state_to_numpy", "params_from_numpy", "params_to_numpy",
           "cache_from_numpy", "cache_to_numpy"]

_TABLE_ARRAYS = ("active", "head", "split", "deliver", "spread", "dist_act",
                 "hval_rem", "slot_ok", "router_ok", "dest_ok", "routable")


def graph_from_arrays(n: int, edges, meta: dict | None = None,
                      name: str = "") -> Graph:
    """The port's Graph from a vertex count, an (E, 2) edge array and the
    family metadata (``leaf_mask``, ``dims``, ...)."""
    meta = {key: (np.array(v) if isinstance(v, np.ndarray) else v)
            for key, v in (meta or {}).items()}
    return Graph(int(n), np.array(edges, dtype=np.int64), name=name,
                 meta=meta)


def fault_set_from_arrays(links=(), routers=()) -> FaultSet:
    """The port's FaultSet from endpoint pairs of down links and ids of
    down routers (a reference FaultSet's ``links`` and ``routers``)."""
    return FaultSet(links=tuple(map(tuple, links)), routers=tuple(routers))


def placement_from_arrays(graph: Graph, mesh_shape, axis_names,
                          router_of) -> Placement:
    """The port's Placement of a mesh on the port's ``graph`` from its
    shape, axis names and chip -> router array (a reference Placement's
    ``mesh_shape``, ``axis_names`` and ``router_of``)."""
    router_of = np.array(router_of, dtype=np.int64)
    if router_of.shape != (int(np.prod(mesh_shape)),):
        raise ValueError(f"router_of has shape {router_of.shape}, the mesh "
                         f"{tuple(mesh_shape)} has {int(np.prod(mesh_shape))}"
                         f" chips")
    if router_of.size and not (0 <= router_of.min()
                               and router_of.max() < graph.n):
        raise ValueError(f"router_of names routers outside 0..{graph.n - 1}")
    return Placement(graph, tuple(int(m) for m in mesh_shape),
                     tuple(axis_names), router_of)


def tables_from_numpy(device=None, **fields) -> RouteTables:
    """RouteTables from numpy fields named as the dataclass's (``n``,
    ``k``, ``m``, ``active``, ``head``, ``split``, ..., the fault masks
    ``slot_ok``, ``router_ok``, ``dest_ok``, ``routable`` and
    ``faulted``), as tensors on ``device`` with the arrays' dtypes."""
    device = resolve_device(device)
    kw = {"n": int(fields["n"]), "k": int(fields["k"]),
          "m": int(fields["m"]),
          "faulted": bool(fields.get("faulted", False))}
    for key in _TABLE_ARRAYS:
        arr = fields.get(key)
        if arr is None:
            continue
        kw[key] = torch.as_tensor(np.ascontiguousarray(arr), device=device)
    return RouteTables(**kw)


def state_from_numpy(state, device=None) -> SimState:
    """SimState from a 6-tuple of arrays (q0, q1, q2, src, pend, stage2),
    dtypes kept."""
    device = resolve_device(device)
    return SimState(*(torch.as_tensor(np.ascontiguousarray(a), device=device)
                      for a in state))


def state_to_numpy(state) -> tuple:
    """The 6-tuple of numpy arrays of a SimState (or of a state tuple)."""
    if isinstance(state, SimState):
        state = state.as_tuple()
    return tuple(a.detach().cpu().numpy() for a in state)


# ---------------------------------------------------------------------------
# Model weights and serve caches
# ---------------------------------------------------------------------------


def _tensor(arr, device) -> torch.Tensor:
    """A tensor of ``arr``; bfloat16 arrays (numpy's ml_dtypes extension
    type, as JAX hands them out) become bfloat16 tensors."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.as_tensor(np.array(arr), device=device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _per_layer(cfg: ArchConfig, tree) -> list:
    """The per-layer subtrees of a (prefix | stacked body | suffix) tree,
    in layer order."""
    plan = layer_plan(cfg)
    layers = list(tree.get("prefix") or [])
    body = tree.get("body") or {}
    for r in range(plan.reps):
        for j in range(plan.period):
            layers.append(_tree_map(lambda a, r=r: np.asarray(a)[r],
                                    body[f"pos{j}"]))
    layers += list(tree.get("suffix") or [])
    return layers


def _flatten(prefix: str, tree, out: dict) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(f"{prefix}{key}.", val, out)
        else:
            out[prefix + key] = val


def params_from_numpy(cfg: ArchConfig, tree, device=None) -> Model:
    """The port's model holding the reference's weights: ``tree`` is the
    reference's unboxed parameter pytree as arrays (``embed``,
    ``lm_head`` unless tied, ``prefix``/``body``/``suffix`` with the
    stacked layer axis, ``final_norm``, ``mtp`` for an MTP config,
    ``encoder`` for an encoder config: ``body.pos0`` stacked over the
    encoder's layers, ``adapter``, ``final_norm``; a cross layer's
    ``gate`` among its weights).  Every weight must be there."""
    device = resolve_device(device)
    build(cfg)                                # raises for unknown kinds
    model = Model(cfg, device=device, generator=None)
    flat = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        flat["lm_head"] = tree["lm_head"]
    if cfg.mtp:
        _flatten("mtp.", tree["mtp"], flat)
    if cfg.encoder is not None:
        enc = tree["encoder"]
        flat["encoder.adapter"] = enc["adapter"]
        flat["encoder.final_norm"] = enc["final_norm"]
        for i in range(cfg.encoder.n_layers):
            _flatten(f"encoder.blocks.{i}.",
                     _tree_map(lambda a, i=i: np.asarray(a)[i],
                               enc["body"]["pos0"]), flat)
    for i, layer in enumerate(_per_layer(cfg, tree)):
        _flatten(f"blocks.{i}.", layer, flat)
    model.load_state_dict({k: _tensor(v, device) for k, v in flat.items()},
                          strict=True)
    return model


def params_to_numpy(cfg: ArchConfig, params) -> dict:
    """The reference's parameter tree of numpy arrays (``embed``,
    ``lm_head`` unless tied, ``prefix``/``body``/``suffix`` with the
    stacked layer axis, ``final_norm``, ``mtp`` for an MTP config,
    ``encoder`` for an encoder config; bfloat16 leaves as float32) from
    the port's :class:`Model` or a dict of tensors under its parameter
    names (a train state's ``params``, or gradients)."""
    if isinstance(params, Model):
        params = dict(params.named_parameters())
    host = {k: (t.detach().float() if t.dtype == torch.bfloat16
                else t.detach()).cpu().numpy() for k, t in params.items()}
    layers = [dict() for _ in range(cfg.n_layers)]
    enc_layers = [dict() for _ in range(
        cfg.encoder.n_layers if cfg.encoder is not None else 0)]
    tree = {}
    for name, arr in host.items():
        node, rest = tree, name
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            node = layers[int(i)]
        elif name.startswith("encoder.blocks."):
            _, _, i, rest = name.split(".", 3)
            node = enc_layers[int(i)]
        *path, leaf = rest.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    plan = layer_plan(cfg)
    body_end = plan.prefix + plan.reps * plan.period
    tree["prefix"] = layers[:plan.prefix]
    tree["body"] = {f"pos{j}": _stack(layers[plan.prefix + j:body_end:
                                             plan.period])
                    for j in range(plan.period if plan.reps else 0)}
    tree["suffix"] = layers[body_end:]
    if enc_layers:
        tree["encoder"]["body"] = {"pos0": _stack(enc_layers)}
    return tree


def cache_from_numpy(cfg: ArchConfig, tree, device=None):
    """The port's cache from a reference cache tree of arrays
    (``prefix``/``body``/``suffix``, body leaves stacked): the per-layer
    list, or ``{"layers": [...], "enc_memory": ...}`` where the tree has
    an ``enc_memory``."""
    device = resolve_device(device)
    layers = [_tree_map(lambda a: _tensor(a, device), layer)
              for layer in _per_layer(cfg, tree)]
    if "enc_memory" not in tree:
        return layers
    return {"layers": layers,
            "enc_memory": _tensor(tree["enc_memory"], device)}


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def cache_to_numpy(cfg: ArchConfig, cache) -> dict:
    """The reference's cache tree of numpy arrays (bfloat16 leaves as
    float32) from the port's cache (the per-layer list, or ``{"layers":
    [...], "enc_memory": ...}``)."""
    plan = layer_plan(cfg)
    host = [_tree_map(_host, layer) for layer in layers_of(cache)]
    body_end = plan.prefix + plan.reps * plan.period
    tree = {"prefix": host[:plan.prefix], "suffix": host[body_end:]}
    if plan.reps:                   # the reference has no body otherwise
        tree["body"] = {f"pos{j}": _stack(host[plan.prefix + j:body_end:
                                               plan.period])
                        for j in range(plan.period)}
    if isinstance(cache, dict):
        tree["enc_memory"] = _host(cache["enc_memory"])
    return tree


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
