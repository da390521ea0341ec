"""Shared model machinery of the port: logical sharding axes, the rules
that resolve them onto a mesh, DTensor placements, and the dtype
policy.

Counterpart of ``repro/models/common.py``.  The reference boxes every
weight with its logical axes (``Boxed``); the port's weights are the
named parameters of an ``nn.Module``, and their axes come from
:func:`repro_torch.models.model.param_axes`.  A spec is a plain tuple
with one entry per tensor dim, each ``None``, a mesh axis name, or a
tuple of names: the counterpart of a ``PartitionSpec``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or any
object with ``axis_names`` and ``devices`` (a numpy array of the mesh's
shape) as the reference's resolution reads it, or a dict ``{axis name:
size}``.

:func:`placements` turns a spec into DTensor placements, one per mesh
dim: ``Shard(d)`` on every mesh dim that a tensor dim d is split over,
``Replicate()`` elsewhere.  A tensor dim split over two mesh dims (the
``fsdp`` rule's ``("data", "pod")``) is cut by DTensor in mesh-dim
order: on the (pod, data, model) mesh the device at (p, d, m) holds
block ``p * n_data + d`` of that dim, where the reference's
``("data", "pod")`` names the data-major block ``d * n_pod + p``.  Every
device holds a block of the same size in both, so the bytes per device
are the reference's; only which device holds which block differs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["ShardingRules", "DEFAULT_RULES", "axis_sizes", "resolve_specs",
           "placements", "local_shape", "Policy", "DEFAULT_POLICY"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    rules: tuple[tuple[str, Any], ...]

    def lookup(self, name: str | None):
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def replace(self, **kw) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(tuple(d.items()))


DEFAULT_RULES = ShardingRules(rules=(
    ("batch", ("pod", "data")),
    ("fsdp", ("data", "pod")),  # ZeRO-3 weight-shard dims (large models)
    ("embed", None),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("expert", "model"),
    ("expert_ff", "fsdp_proxy"),  # resolved via the 'fsdp' rule at use site
    ("seq", None),
    ("kv_seq", None),
    ("state", None),
    ("conv", None),
))


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, a stand-in with
    ``axis_names`` and ``devices``, or such a dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _resolve_one(axes, rules: ShardingRules, sizes: dict, shape):
    spec, used = [], set()
    for d, name in enumerate(axes):
        assign = rules.lookup(name)
        if assign == "fsdp_proxy":
            assign = rules.lookup("fsdp")
        ok = None
        if assign is not None:
            parts = (assign,) if isinstance(assign, str) else tuple(assign)
            parts = tuple(p for p in parts if p in sizes and p not in used)
            total = int(np.prod([sizes[p] for p in parts])) if parts else 1
            if parts and (shape is None or shape[d] % total == 0):
                ok = parts if len(parts) > 1 else parts[0]
                used.update(parts)
        spec.append(ok)
    return tuple(spec)


def resolve_specs(axes, rules: ShardingRules, mesh, shape=None):
    """Logical axes -> spec, as the reference resolves them: an
    assignment that does not divide its dim is dropped (kv_heads = 1 on
    a 16-way model axis falls back to replication), no mesh axis is used
    twice in one spec, and with ``shape=None`` nothing is checked for
    divisibility.  ``axes`` is one tuple (``shape`` its tensor's shape or
    None) or a dict of them (``shape`` a dict of shapes or None)."""
    sizes = axis_sizes(mesh)
    if _is_axes(axes):
        return _resolve_one(axes, rules, sizes,
                            None if shape is None else tuple(shape))
    return {k: resolve_specs(a, rules, sizes,
                             None if shape is None else shape[k])
            for k, a in axes.items()}


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim in
    the mesh's order (see the module's docstring).  A mesh dim of one
    device is ``Replicate()``: a split one way is no split, and DTensor's
    view rules refuse to reshape a dim "sharded" there (a single kv
    head's)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, size in axis_sizes(mesh).items():
        dims = [d for d, e in enumerate(spec) if name in _names(e)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's block of a tensor of ``shape`` under
    ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(n // int(np.prod([sizes[a] for a in _names(e)]))
                 for n, e in zip(shape, spec))


@dataclasses.dataclass(frozen=True)
class Policy:
    """dtype policy: storage/compute/softmax accumulation."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, tree):
        """Floating tensors of a dict tree in the compute dtype."""
        if isinstance(tree, dict):
            return {k: self.cast_compute(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self.compute_dtype)
        return tree


DEFAULT_POLICY = Policy()
