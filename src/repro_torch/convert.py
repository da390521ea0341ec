"""Carry topology, route tables and fluid state across from plain arrays.

The reference package builds graph families this slice does not port yet
(tori, fat trees, placement graphs) and keeps its tables and state as
numpy arrays.  These helpers build the port's objects from such arrays,
so both packages compute the same thing on the same inputs.  They take
arrays, never objects of the reference, and import nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.graph import Graph
from .sim.engine import SimState
from .sim.tables import RouteTables

__all__ = ["graph_from_arrays", "tables_from_numpy", "state_from_numpy",
           "state_to_numpy"]

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


def tables_from_numpy(device=None, **fields) -> RouteTables:
    """RouteTables from numpy fields named as the dataclass's (``n``,
    ``k``, ``m``, ``active``, ``head``, ``split``, ...), as tensors on
    ``device`` with the arrays' dtypes.  Faulted tables are not supported
    yet."""
    if fields.get("faulted", False):
        raise NotImplementedError("fault-aware tables are not ported yet")
    device = resolve_device(device)
    kw = {"n": int(fields["n"]), "k": int(fields["k"]),
          "m": int(fields["m"]), "faulted": False}
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
