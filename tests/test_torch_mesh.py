"""The port's sharding rules (``repro_torch.models.common``), parameter
specs (``ModelBundle.param_specs``), DTensor placements and batch specs
against the reference's.

The reference's specs come from ``build(cfg).param_specs(mesh)`` on a
stand-in mesh (``axis_names`` and ``devices``, all that its
``resolve_specs`` reads), so every arch resolves at full width with no
device.  Its scanned layers are stacked: a body leaf's spec has a
leading ``None`` for the layer dim, which the port's per-layer
parameters do not have."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS
from repro.configs import get_arch as ref_get_arch
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import batch_specs as ref_batch_specs
from repro.models import build as ref_build
from repro.models.common import DEFAULT_RULES as REF_RULES
from repro.models.common import boxed_specs as ref_boxed_specs
from repro.models.common import resolve_specs as ref_resolve_specs
from repro.models.transformer import layer_plan as ref_layer_plan
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, batch_specs
from repro_torch.models import build
from repro_torch.models.common import (DEFAULT_RULES, local_shape,
                                       placements, resolve_specs)
from repro_torch.models.model import param_axes, param_shapes


class _StandIn:
    """The reference's view of a mesh: axis names and a device array."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch: str):
    return ref_build(ref_get_arch(arch)).abstract_params()


def _ref_flat(arch: str, specs) -> dict:
    """The reference's spec tree under the port's parameter names, the
    stacked layer dim dropped."""
    cfg = ref_get_arch(arch)
    plan = ref_layer_plan(cfg)
    out = {}

    def walk(prefix, node, stacked):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v, stacked)
        else:
            spec = tuple(node)
            out[prefix[:-1]] = spec[1:] if stacked else spec

    for key in ("embed", "lm_head", "final_norm"):
        if key in specs:
            out[key] = tuple(specs[key])
    for i, layer in enumerate(specs["prefix"]):
        walk(f"blocks.{i}.", layer, False)
    for r in range(plan.reps):
        for j in range(plan.period):
            walk(f"blocks.{plan.prefix + r * plan.period + j}.",
                 specs["body"][f"pos{j}"], True)
    base = plan.prefix + plan.reps * plan.period
    for i, layer in enumerate(specs["suffix"]):
        walk(f"blocks.{base + i}.", layer, False)
    if "encoder" in specs:
        enc = specs["encoder"]
        out["encoder.adapter"] = tuple(enc["adapter"])
        out["encoder.final_norm"] = tuple(enc["final_norm"])
        for i in range(cfg.encoder.n_layers):
            walk(f"encoder.blocks.{i}.", enc["body"]["pos0"], True)
    if "mtp" in specs:
        walk("mtp.", specs["mtp"], False)
    return out


CASES = [(a, m, False) for a in ARCHS for m in MESHES] + \
    [(a, "16x16", True) for a in ARCHS]


@pytest.mark.parametrize("arch,mesh_name,no_ff", CASES,
                         ids=[f"{a}-{m}{'-ff=None' if f else ''}"
                              for a, m, f in CASES])
def test_param_specs_match_reference(arch, mesh_name, no_ff):
    """Every parameter's resolved spec equals the reference leaf's, on
    each mesh and with ``ff`` unsharded (the ``replicate_ff`` flag's
    rules)."""
    shape, names = MESHES[mesh_name]
    mesh = _StandIn(shape, names)
    ref_rules = REF_RULES.replace(ff=None) if no_ff else REF_RULES
    rules = DEFAULT_RULES.replace(ff=None) if no_ff else DEFAULT_RULES
    want = _ref_flat(arch, ref_boxed_specs(_ref_abstract(arch), ref_rules,
                                           mesh))
    got = build(get_arch(arch)).param_specs(mesh, rules)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == want[name], name


def test_rules_are_the_reference_rules():
    assert DEFAULT_RULES.rules == REF_RULES.rules
    assert DEFAULT_RULES.replace(ff=None).rules \
        == REF_RULES.replace(ff=None).rules
    for name, _ in REF_RULES.rules + (("nothing", None),):
        assert DEFAULT_RULES.lookup(name) == REF_RULES.lookup(name)
    assert DEFAULT_RULES.lookup(None) is None


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_specs_without_shape_matches_reference(mesh_name):
    """``shape=None`` checks no divisibility: every rule's assignment
    lands where its axes exist, none used twice."""
    shape, names = MESHES[mesh_name]
    mesh = _StandIn(shape, names)
    axes = {"a": ("batch", None, "vocab"), "b": ("fsdp", "heads", None),
            "c": ("expert", None, "expert_ff"), "d": ("ff", "ff"),
            "e": ("batch", "fsdp"), "f": (), "g": ("kv_heads", "embed")}
    want = ref_resolve_specs(axes, REF_RULES, mesh)
    got = resolve_specs(axes, DEFAULT_RULES, mesh)
    assert got == {k: tuple(v) for k, v in want.items()}
    # with shapes: an assignment that does not divide is dropped
    shapes = {"a": (3, 5, 7), "b": (32, 8, 2), "c": (8, 4, 16),
              "d": (16, 16), "e": (4, 4), "f": (), "g": (1, 64)}
    want = ref_resolve_specs(axes, REF_RULES, mesh, shapes)
    got = resolve_specs(axes, DEFAULT_RULES, mesh, shapes)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("memory", [0, 12])
def test_batch_specs_match_reference(memory):
    kw = dict(vocab=100, seq_len=64, global_batch=8, memory_tokens=memory,
              d_model=32)
    want = ref_batch_specs(RefDataConfig(**kw))
    got = batch_specs(DataConfig(**kw))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype)


def test_param_axes_cover_every_parameter():
    cfg = get_arch("deepseek-v3-671b").reduced()
    axes, shapes = param_axes(cfg), param_shapes(cfg)
    assert set(axes) == set(shapes)
    for name, ax in axes.items():
        assert len(ax) == len(shapes[name][0]), name


@pytest.fixture
def fake_world():
    from repro_torch.launch.dryrun import fake_world as world
    with world(512):
        yield
    assert not dist.is_initialized()


def test_placements_give_the_reference_bytes_per_device(fake_world):
    """DTensor's block of every parameter under :func:`placements` on a
    (2, 16, 16) mesh of a fake 512-rank world has the bytes that the
    reference's spec gives a device (each dim divided by the product of
    its axes' sizes), for every arch; the pod-and-data split of an
    ``fsdp`` dim is cut pod-major by DTensor (see ``models.common``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, names = MESHES["2x16x16"]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    stand = _StandIn(shape, names)
    sizes = dict(zip(names, shape))
    for arch in ARCHS:
        want = _ref_flat(arch, ref_boxed_specs(_ref_abstract(arch),
                                               REF_RULES, stand))
        got_bytes = want_bytes = 0
        for name, (gshape, dtype) in param_shapes(get_arch(arch)).items():
            spec = want[name]
            loc, _ = compute_local_shape_and_global_offset(
                gshape, mesh, placements(spec, mesh))
            assert tuple(loc) == local_shape(gshape, spec, mesh), name
            ref_loc = [n // int(np.prod([sizes[a] for a in (
                (e,) if isinstance(e, str) else (e or ()))]))
                for n, e in zip(gshape, spec)]
            item = torch.empty((), dtype=dtype).element_size()
            got_bytes += int(np.prod(loc)) * item
            want_bytes += int(np.prod(ref_loc)) * item
        assert got_bytes == want_bytes, arch


def test_placements_of_a_two_axis_dim():
    sizes = {"pod": 2, "data": 16, "model": 16}
    from torch.distributed.tensor import Replicate, Shard
    assert placements((("data", "pod"), "model"), sizes) == (
        Shard(0), Shard(0), Shard(1))
    assert placements((None, None), sizes) == (Replicate(),) * 3
    assert local_shape((64, 32), (("data", "pod"), "model"), sizes) \
        == (2, 2)
