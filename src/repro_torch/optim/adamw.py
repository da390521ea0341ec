"""AdamW as plain functions on dicts of tensors (name -> tensor).

Counterpart of ``repro/optim/adamw.py``, with its arithmetic: gradients
clipped by their global norm (the square root of the summed float32
squares), moments in ``state_dtype`` (bf16 for the 671B-scale configs),
bias correction with the count after its increment, and ``p - lr *
(update + weight_decay * p)`` on every leaf, embeddings and norm gains
included.  ``torch.optim.AdamW`` orders decay and update differently and
is not used.  Everything stays on the parameters' device: no host sync.
:func:`adamw_update_` is the same update in place (the reference's
donated step): each leaf's new values are computed as
:func:`adamw_update` computes them and copied into the old tensors,
leaf by leaf, so the two give the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_update_", "global_norm", "cosine_schedule"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor      # int32 scalar on the parameters' device


def adamw_init(params: dict, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    m = {k: torch.zeros_like(p, dtype=cfg.state_dtype)
         for k, p in params.items()}
    v = {k: torch.zeros_like(p, dtype=cfg.state_dtype)
         for k, p in params.items()}
    device = next(iter(params.values())).device if params else "cpu"
    return AdamWState(m, v, torch.zeros((), dtype=torch.int32,
                                        device=device))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares, the
    leaves added in the order of their sorted names, as
    ``jax.tree.leaves`` orders a dict.  The sum's rounding, and so a
    clipped step, must not depend on the dict's order: a state restored
    from a checkpoint lists its leaves sorted, one in memory in the
    model's order."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def _prologue(grads: dict, count, cfg: AdamWConfig):
    """The step's shared scalars: ``(clip scale, lr, 1 - b1^t, 1 - b2^t,
    grad norm)`` for the incremented ``count``."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else 1.0)
    lr = cfg.lr(count) if callable(cfg.lr) else cfg.lr
    cf = count.float()
    return scale, lr, 1.0 - cfg.b1 ** cf, 1.0 - cfg.b2 ** cf, gnorm


def _leaf(g, m, v, p, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """One leaf's ``(new p, new m, new v)`` in their stored dtypes."""
    g = g.float() * scale
    m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
    v32 = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
    update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
    p32 = p.float()
    p_new = p32 - lr * (update + cfg.weight_decay * p32)
    return (p_new.to(p.dtype), m32.to(cfg.state_dtype),
            v32.to(cfg.state_dtype))


def _metrics(gnorm, lr, count) -> dict:
    return {"grad_norm": gnorm,
            "lr": torch.as_tensor(lr, dtype=torch.float32,
                                  device=count.device)}


def adamw_update(grads: dict, state: AdamWState, params: dict,
                 cfg: AdamWConfig = AdamWConfig()):
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``; new
    tensors, the inputs are left as they were."""
    count = state.count + 1
    scale, lr, b1c, b2c, gnorm = _prologue(grads, count, cfg)
    new_p, new_m, new_v = {}, {}, {}
    for key, p in params.items():
        new_p[key], new_m[key], new_v[key] = _leaf(
            grads[key], state.m[key], state.v[key], p, scale, lr, b1c, b2c,
            cfg)
    return new_p, AdamWState(new_m, new_v, count), _metrics(gnorm, lr, count)


@torch.no_grad()
def adamw_update_(grads: dict, state: AdamWState, params: dict,
                  cfg: AdamWConfig = AdamWConfig()):
    """:func:`adamw_update` in place: ``params``, ``state.m``, ``state.v``
    and ``state.count`` take the new values, bit for bit those that
    :func:`adamw_update` returns, and are returned.  ``grads`` is emptied
    leaf by leaf as it is used, so each gradient and its leaf's float32
    temporaries are freed before the next leaf."""
    state.count.add_(1)
    scale, lr, b1c, b2c, gnorm = _prologue(grads, state.count, cfg)
    for key, p in params.items():
        p_new, m_new, v_new = _leaf(grads.pop(key), state.m[key],
                                    state.v[key], p, scale, lr, b1c, b2c,
                                    cfg)
        p.copy_(p_new)
        state.m[key].copy_(m_new)
        state.v[key].copy_(v_new)
        del p_new, m_new, v_new
    return params, state, _metrics(gnorm, lr, state.count)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """``lr(step)``: linear warmup to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``; float32 on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr
