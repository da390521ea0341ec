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
and metrics averaged the same way; otherwise the plain step runs.  It
needs no mesh.  The mesh and ``zero1`` belong to the multi-device
slice: ``zero1=True`` raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models import Model, build
from ..optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                     adamw_update_, ef_compress_grads, ef_init)
from ..perf import flags

__all__ = ["TrainStepConfig", "init_train_state", "train_state_from_model",
           "make_train_step"]


@dataclass(frozen=True)
class TrainStepConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_compress: bool = False       # error-feedback int8
    zero1: bool = False               # multi-device slice; raises here


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


def make_train_step(cfg: ArchConfig, device=None,
                    ts: TrainStepConfig = TrainStepConfig(),
                    donate: bool = True):
    """``step_fn(state, batch) -> (new_state, metrics)`` on ``device``
    (default: the card).  ``batch["tokens"]`` (B, S) integer tensor or
    array, plus ``batch["memory"]`` (B, T, M) for a memory-input config;
    metrics ``loss``, ``ce``, ``aux`` (and ``mtp`` for an MTP config),
    ``grad_norm`` and ``lr``, scalar tensors on the device.  ``donate``:
    update the old state in place (see the module's docstring)."""
    if ts.zero1:
        raise NotImplementedError("zero1 shards the optimizer over a "
                                  "mesh: the multi-device slice (ROADMAP "
                                  "queue 1)")
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
