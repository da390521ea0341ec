"""The train step: loss and gradients through the model (flash-attention
forward and backward kernels, remat per block), optional error-feedback
int8 compression of the gradients, then AdamW.

Counterpart of ``repro/train/train_step.py`` on one device.  The train
state is a dict ``{"params": {name: tensor}, "opt": {"m": {...}, "v":
{...}, "count": int32}, "step": int32[, "ef": {...}]}``, the parameter
names those of :class:`~repro_torch.models.Model`.  ``step_fn(state,
batch) -> (state, metrics)`` donates the old state by default, as the
reference's jitted step does: params, moments, count and step are
updated in place (:func:`~repro_torch.optim.adamw_update_`), leaf by
leaf, and the returned state holds the same tensors.  With
``donate=False`` it returns new tensors and leaves the old state as it
was; both give the same bits.  Donation is what lets a 3.4B-parameter
float32 state (params, gradients and two moments: 54 GB) train on one
80 GB card, where a second params, m and v would not fit.

The ``microbatch`` perf flag (``REPRO_PERF=microbatch=N``) accumulates
gradients inside the step as the reference does: where N > 1 divides
the batch, the batch splits into N microbatches of consecutive rows,
and ``g_acc + g / N`` runs from zeros in microbatch order, leaf by leaf
in place (one more set of gradients beside the state, not two), loss
and metrics averaged the same way; otherwise the plain step runs.

On a mesh (``mesh``, a ``DeviceMesh`` of more than one device; every
family) the state's tensors are DTensors placed by
:func:`make_train_state_specs` (the reference's specs: params, m and v
by the parameter specs, ``count`` and ``step`` replicated) and the
batch, its tokens and a memory-input config's memory, is sharded over
the batch axes (:func:`batch_pspec`).  The loss
runs with ``mesh`` and its backward under ``loss_parallel``; then each
gradient is reduced explicitly to its parameter's placements, before the
clip and AdamW: the data-parallel all-reduce (a weight sharded over the
batch axes, ``fsdp``, gets its gradient by reduce-scatter already in the
backward).  ``zero1=True`` is the reference's rule: a gradient whose
parameter is replicated and whose first dim the ``data`` axis divides is
reduce-scattered over ``data`` instead, its AdamW moments are kept
sharded over ``data`` (ZeRO-1: each data rank owns a slice of the
optimizer state; the reference keeps m and v at the parameter's spec and
leaves the layout to GSPMD), the update runs on the slice, and the
parameter comes back by all-gather.  A one-device mesh shards nothing:
the step is the plain one, ``zero1`` included, bit for bit.  The
``microbatch`` flag and ``grad_compress`` are not run on a mesh yet
(they raise).  ``COLLECTIVE_PHASE`` names the part of the step that is
running (``"loss"``, ``"gradients"``, ``"optimizer"``), so that the dry
run can book each collective to it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

import contextlib

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models import Model, build
from ..models.common import (DEFAULT_RULES, ShardingRules, axis_sizes,
                             placements)
from ..optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                     adamw_update_, ef_compress_grads, ef_init)
from ..perf import flags

__all__ = ["TrainStepConfig", "init_train_state", "train_state_from_model",
           "make_train_step", "make_train_state_specs", "batch_pspec",
           "COLLECTIVE_PHASE", "AFTER_FORWARD"]

COLLECTIVE_PHASE = {"name": None}
# callables the mesh step calls with no argument between its forward and
# its backward (the dry run reads the card's memory there)
AFTER_FORWARD: list = []


@contextlib.contextmanager
def _phase(name: str):
    prev = COLLECTIVE_PHASE["name"]
    COLLECTIVE_PHASE["name"] = name
    try:
        yield
    finally:
        COLLECTIVE_PHASE["name"] = prev


@dataclass(frozen=True)
class TrainStepConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_compress: bool = False       # error-feedback int8
    zero1: bool = False               # reduce-scatter/all-gather grad path
    rules: ShardingRules = DEFAULT_RULES


def _opt_cfg(cfg: ArchConfig, ts: TrainStepConfig) -> AdamWConfig:
    """bf16 AdamW moments for bf16-param archs, as the reference."""
    if cfg.bf16_params and ts.optimizer.state_dtype == torch.float32:
        return dataclasses.replace(ts.optimizer, state_dtype=torch.bfloat16)
    return ts.optimizer


def train_state_from_model(cfg: ArchConfig, model: Model,
                           ts: TrainStepConfig = TrainStepConfig()) -> dict:
    """A fresh train state holding ``model``'s weights (shared, not
    copied)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = {"params": params,
             "opt": adamw_init(params, _opt_cfg(cfg, ts))._asdict(),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=model.device)}
    if ts.grad_compress:
        state["ef"] = ef_init(params)
    return state


def init_train_state(cfg: ArchConfig, seed: int = 0,
                     ts: TrainStepConfig = TrainStepConfig(),
                     device=None) -> dict:
    """A fresh train state with weights from a ``torch.Generator`` seeded
    with ``seed``, on ``device`` (default: the card)."""
    return train_state_from_model(cfg, build(cfg).init(seed, device), ts)


def _bind(model: Model, params: dict) -> dict:
    """Make ``params`` the model's parameters (sharing their storage) as
    leaves that record gradients; returns them by name."""
    bound = {}
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        p = nn.Parameter(t)
        model.get_submodule(owner)._parameters[leaf] = p
        bound[name] = p
    return bound


def _device_batch(batch, device) -> dict:
    """The batch on ``device``: ``tokens`` and, where given, ``memory``
    (the frame or image embeddings of a memory-input config)."""
    out = {"tokens": torch.as_tensor(batch["tokens"], device=device)}
    if batch.get("memory") is not None:
        out["memory"] = torch.as_tensor(batch["memory"], device=device)
    return out


def _zero1_leaf(spec, shape, dsize: int) -> bool:
    """The reference's ZeRO-1 rule: a replicated leaf whose first dim
    the data axis (of size ``dsize`` > 1) divides."""
    return (all(a is None for a in spec) and len(shape) > 0
            and shape[0] % dsize == 0 and dsize > 1)


def make_train_state_specs(cfg: ArchConfig, mesh,
                           ts: TrainStepConfig = TrainStepConfig()) -> dict:
    """The spec tree of the whole train state: params, m and v by the
    parameter specs (m and v of a ZeRO-1 leaf over ``data`` on dim 0
    under ``zero1``), ``count`` and ``step`` replicated."""
    bundle = build(cfg)
    pspecs = bundle.param_specs(mesh, ts.rules)
    mspecs = dict(pspecs)
    if ts.zero1:
        from ..models.model import param_shapes
        dsize = axis_sizes(mesh).get("data", 1)
        for name, (shape, _) in param_shapes(cfg).items():
            if _zero1_leaf(pspecs[name], shape, dsize):
                mspecs[name] = ("data",) + (None,) * (len(shape) - 1)
    specs = {"params": pspecs,
             "opt": {"m": mspecs, "v": dict(mspecs), "count": ()},
             "step": ()}
    if ts.grad_compress:
        specs["ef"] = dict(pspecs)
    return specs


def batch_pspec(mesh) -> tuple:
    """The batch's spec: dim 0 over the mesh's ``("pod", "data")``
    axes."""
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return (axes or None,)


def make_train_step(cfg: ArchConfig, device=None,
                    ts: TrainStepConfig = TrainStepConfig(),
                    donate: bool = True, mesh=None):
    """``step_fn(state, batch) -> (new_state, metrics)`` on ``device``
    (default: the card).  ``batch["tokens"]`` (B, S) integer tensor or
    array, plus ``batch["memory"]`` (B, T, M) for a memory-input config;
    metrics ``loss``, ``ce``, ``aux`` (and ``mtp`` for an MTP config),
    ``grad_norm`` and ``lr``, scalar tensors on the device.  ``donate``:
    update the old state in place (see the module's docstring).
    ``mesh``: a ``DeviceMesh``; the state's tensors are then DTensors by
    :func:`make_train_state_specs` and ``batch["tokens"]`` a DTensor or
    a global array that every rank holds (see the module's docstring)."""
    if mesh is not None and mesh.size() > 1:
        return _make_mesh_step(cfg, ts, donate, mesh)
    device = resolve_device(device)
    bundle = build(cfg)
    model = Model(cfg, device="meta")      # weights bound at every step
    opt_cfg = _opt_cfg(cfg, ts)

    def value_and_grad(params, batch):
        loss, metrics = bundle.loss(model, batch)
        names = list(params)
        # a weight the loss never reads (a MoE's shared-expert norm, which
        # the reference carries unused too) gets a zero gradient
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names], allow_unused=True,
            materialize_grads=True)))
        return loss.detach(), {k: v.detach() for k, v in
                               metrics.items()}, grads

    def accumulated(params, batch, mb: int):
        """The reference's microbatch scan: sums of ``x / mb`` from
        zeros, in microbatch order."""
        g_acc = {n: torch.zeros_like(p) for n, p in params.items()}
        loss_acc, m_acc = None, None
        for part in zip(*(t.chunk(mb) for t in batch.values())):
            loss, metrics, grads = value_and_grad(
                params, dict(zip(batch, part)))
            for n in list(grads):
                g_acc[n].add_(grads.pop(n) / mb)
            if loss_acc is None:
                loss_acc = torch.zeros_like(loss)
                m_acc = {k: torch.zeros_like(v) for k, v in metrics.items()}
            loss_acc += loss / mb
            for k, v in metrics.items():
                m_acc[k] += v / mb
        return loss_acc, m_acc, g_acc

    def step_fn(state, batch):
        params = _bind(model, state["params"])
        batch = _device_batch(batch, device)
        mb = int(flags().microbatch)
        if mb > 1 and batch["tokens"].shape[0] % mb == 0:
            loss, metrics, grads = accumulated(params, batch, mb)
        else:
            loss, metrics, grads = value_and_grad(params, batch)
        if ts.grad_compress:
            grads, new_ef = ef_compress_grads(grads, state["ef"])
        opt = AdamWState(state["opt"]["m"], state["opt"]["v"],
                         state["opt"]["count"])
        if donate:
            new_params, new_opt, opt_metrics = adamw_update_(
                grads, opt, state["params"], opt_cfg)
            step = state["step"].add_(1)
            if ts.grad_compress:
                for key, e in new_ef.items():
                    state["ef"][key].copy_(e)
                new_ef = state["ef"]
        else:
            new_params, new_opt, opt_metrics = adamw_update(
                grads, opt, state["params"], opt_cfg)
            _bind(model, new_params)       # drop the old weights
            step = state["step"] + 1
        new_state = {"params": new_params, "opt": new_opt._asdict(),
                     "step": step}
        if ts.grad_compress:
            new_state["ef"] = new_ef
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return new_state, metrics

    return step_fn


def _mesh_batch(batch, mesh) -> dict:
    """``batch["tokens"]`` and, where the batch has one, its ``memory``
    (B, T, M) in bf16, each a DTensor over the batch axes (the
    reference's ``in_shardings``): kept where it is one, else each rank
    takes its rows of the global array it holds."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dev = torch.device(mesh.device_type)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for key in ("tokens", "memory"):
        t = batch.get(key)
        if t is None:
            continue
        if not isinstance(t, DTensor):
            t = distribute_tensor(torch.as_tensor(t, device=dev), mesh,
                                  placements(batch_pspec(mesh), mesh),
                                  src_data_rank=None)
        out[key] = t.to(torch.bfloat16) if key == "memory" else t
    return out


def _reduce_grad(g, mesh, want):
    """Gradient ``g`` (a DTensor, partial sums over the batch axes) at
    placements ``want``: first the blocks that the gradient holds whole
    and the parameter holds sliced are sliced (no bytes move), then the
    partial sums are reduced, so that each device reduces its block and
    no more."""
    mid = tuple(w if (p.is_replicate() and w.is_shard()) else p
                for p, w in zip(g.placements, want))
    if mid != tuple(g.placements):
        g = g.redistribute(mesh, mid)
    return g if tuple(g.placements) == tuple(want) else \
        g.redistribute(mesh, want)


def _make_mesh_step(cfg: ArchConfig, ts: TrainStepConfig, donate: bool,
                    mesh):
    """The train step on a mesh (see the module's docstring)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.parallel import loss_parallel

    if ts.grad_compress:
        raise NotImplementedError("grad_compress on a mesh: ROADMAP "
                                  "queue 1")
    bundle = build(cfg)
    model = Model(cfg, device="meta")      # weights bound at every step
    opt_cfg = _opt_cfg(cfg, ts)
    specs = make_train_state_specs(cfg, mesh, ts)
    want = {n: placements(sp, mesh) for n, sp in specs["params"].items()}
    grad_to = {n: placements(sp, mesh) for n, sp in specs["opt"]["m"]
               .items()}

    def step_fn(state, batch):
        if int(flags().microbatch) > 1:
            raise NotImplementedError("the microbatch flag on a mesh: "
                                      "ROADMAP queue 1")
        params = _bind(model, state["params"])
        batch = _mesh_batch(batch, mesh)
        names = list(params)
        with loss_parallel(), _phase("loss"):
            loss, metrics = bundle.loss(model, batch, mesh=mesh)
            for fn in AFTER_FORWARD:
                fn()
            grads = torch.autograd.grad(
                loss, [params[n] for n in names], allow_unused=True,
                materialize_grads=True)
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        with _phase("gradients"):
            # the data-parallel reduction (reduce-scatter of a ZeRO-1
            # leaf), explicit and leaf by leaf
            grads = {n: _reduce_grad(g, mesh, grad_to[n])
                     for n, g in zip(names, grads)}
        opt = AdamWState(state["opt"]["m"], state["opt"]["v"],
                         state["opt"]["count"])
        with _phase("optimizer"):
            if donate:
                new_params, new_opt, opt_metrics = adamw_update_(
                    grads, opt, state["params"], opt_cfg)
                step = state["step"].add_(1)
            else:
                new_params, new_opt, opt_metrics = adamw_update(
                    grads, opt, state["params"], opt_cfg)
                # a ZeRO-1 leaf's slice comes back by all-gather
                new_params = {n: p if tuple(p.placements) == want[n]
                              else p.redistribute(mesh, want[n])
                              for n, p in new_params.items()}
                _bind(model, new_params)
                step = state["step"] + 1
        new_state = {"params": new_params, "opt": new_opt._asdict(),
                     "step": step}
        metrics = {"loss": loss, **metrics, **opt_metrics}
        metrics = {k: v.to_local() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return new_state, metrics

    return step_fn
