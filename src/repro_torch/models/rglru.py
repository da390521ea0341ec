"""RecurrentGemma / Griffin recurrent block of the port: linear -> causal
depthwise conv -> RG-LRU, gated by a GeLU branch, then the output
projection.

Counterpart of ``repro/models/rglru.py``.  The decode cache is ``{"conv":
(B, d_conv - 1, W), "state": (B, W) float32}``: O(1) a token.  The scan
and its one-token step are :func:`repro_torch.kernels.ops.rglru` and
``rglru_decode_step`` (plain torch; the reference has no kernel for them
either).

On a mesh (training, prefill and decode) the width W is sharded over
``model`` by the ``ff`` rule, as the weights' specs place it, and so
are the cache's conv tail and state; the reference leaves every
placement to GSPMD, the port makes each one explicit.  The depthwise
conv and the scan are elementwise in W and run on each device's block
through ``local_map`` (``ssm._local_channels``); the gate products ``xc
@ w_a`` and ``xc @ w_i`` contract over the sharded W: their float32
partial sums over ``model`` are all-reduced, as the reference's compiled
program reduces them, and cut back to the W-sharded layout of the scan
(:func:`_gate_product`); ``w_out``'s product is a partial sum that the
block reduces at its exit.  A decode step takes the conv step and the
RG-LRU step on each device's channels alike (:meth:`RGLRUBlock.
_on_mesh`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import (branch_out, cast_weight, constant, gelu, rms_norm,
                     truncated_normal)
from .ssm import (_causal_conv, _conv_window, _local_channels,
                  _local_conv_window, _local_tail, _tail)

__all__ = ["RGLRUBlock"]


def _width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def _gate_product(xc, w, mesh):
    """``xc @ w`` for an RG-LRU gate on a mesh: xc (B, S, W) sharded by W
    over ``model``, w (W, W) by its rows.  The float32 partial sums over
    ``model`` (:func:`~repro_torch.models.layers.branch_out`) are
    all-reduced, as the reference's compiled program reduces them, then
    each device keeps its W columns (no bytes move) and rounds them to
    xc's dtype; the backward all-gathers the gate's float32 gradient
    over ``model``, as the reference's does.  A reduce-scatter would
    move 1/``model`` of the forward's bytes."""
    from torch.distributed.tensor import Replicate

    g = branch_out(xc, w)
    g = g.redistribute(mesh, [Replicate() if p.is_partial() else p
                              for p in g.placements])
    return g.redistribute(mesh, xc.placements).to(xc.dtype)


class RGLRUBlock(nn.Module):
    """Parameters as the reference's ``init_rglru_block``: ``norm`` (M,),
    ``w_x``, ``w_gate`` (M, W), ``conv_w`` (d_conv, W), ``conv_b`` (W,),
    ``w_a``, ``w_i`` (W, W), ``a_param`` (W,) (so that the decay a lies in
    0.9..0.999 at a neutral gate), ``w_out`` (W, M)."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        m, w = cfg.d_model, _width(cfg)
        dt = cfg.param_dtype
        self.cfg = cfg
        tn = functools.partial(truncated_normal, dtype=dt, device=device,
                               generator=generator)
        self.norm = constant((m,), 1.0, dt, device)
        self.w_x = tn((m, w))
        self.w_gate = tn((m, w))
        self.conv_w = tn((cfg.rglru.d_conv, w), fan_in_dims=(0,))
        self.conv_b = constant((w,), 0.0, dt, device)
        self.w_a = tn((w, w))
        self.w_i = tn((w, w))
        a = np.linspace(0.9, 0.999, w, dtype=np.float32)
        self.a_param = nn.Parameter(torch.tensor(
            np.log(np.expm1(-np.log(a) / cfg.rglru.c)),
            dtype=torch.float32, device=device).to(dt))
        self.w_out = tn((w, m))

    def forward(self, x, *, mode: str, cache=None, mesh=None):
        """mode 'train', 'prefill' (returns the cache; a given
        ``cache["state"]`` is the scan's initial state) or 'decode' (S =
        1, advances ``cache``).  ``mesh``: on a mesh, x and the weights
        DTensors (see the module's docstring; :meth:`_on_mesh`).
        Returns ``(y (B, S, M), cache)``, the cache None in training."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {mode!r}: 'train', 'prefill' or "
                             f"'decode'")
        if mesh is not None and mode == "prefill" and cache \
                and cache.get("state") is not None:
            raise NotImplementedError("a prefill on a mesh starts from no "
                                      "state")
        cfg = self.cfg
        s = x.shape[1]
        k = cfg.rglru.d_conv
        hidden = rms_norm(x, self.norm, cfg.norm_eps)
        dt = hidden.dtype
        xb = hidden @ cast_weight(self, "w_x", dt)
        gate = gelu(hidden @ cast_weight(self, "w_gate", dt))
        if mesh is not None:
            y, new_cache = self._on_mesh(xb, mode, cache, mesh)
            return branch_out(y * gate, cast_weight(self, "w_out", dt)), \
                new_cache
        if mode == "decode":
            conv_out, new_conv = _conv_window(cache["conv"], xb, self.conv_w,
                                              self.conv_b)
            xc = conv_out.to(x.dtype)
            y, state = ops.rglru_decode_step(
                cache["state"], xc, xc @ cast_weight(self, "w_a", dt),
                xc @ cast_weight(self, "w_i", dt), self.a_param,
                c=cfg.rglru.c)
            y = y[:, None]
            new_cache = {"conv": new_conv, "state": state}
        else:
            xc = _causal_conv(xb, self.conv_w, self.conv_b)
            y, state = ops.rglru(xc, xc @ cast_weight(self, "w_a", dt),
                                 xc @ cast_weight(self, "w_i", dt),
                                 self.a_param,
                                 state=(cache or {}).get("state"),
                                 c=cfg.rglru.c)
            new_cache = ({"conv": _tail(xb, k - 1), "state": state}
                         if mode == "prefill" else None)
        return (y * gate) @ cast_weight(self, "w_out", dt), new_cache

    def _on_mesh(self, xb, mode: str, cache, mesh):
        """The conv and the recurrence of xb (B, S, W), a DTensor split by
        W over ``model``, on each device's channels: training and
        prefill scan the sequence (:func:`~repro_torch.models.ssm.
        _local_channels`; a prefill returns the conv tail and the final
        state, placed as the ``ff`` rule places them), decode takes one
        conv step on the cache's channel blocks (:func:`~repro_torch.
        models.ssm._local_conv_window`) and one RG-LRU step
        (:func:`_local_step`).  The gates' products are
        :func:`_gate_product`'s.  Returns ``(y placed as xb, cache)``."""
        cfg, dt = self.cfg, xb.dtype

        def gates(xc):
            return (_gate_product(xc, cast_weight(self, "w_a", dt), mesh),
                    _gate_product(xc, cast_weight(self, "w_i", dt), mesh))

        if mode == "decode":
            conv_out, new_conv = _local_conv_window(
                cache["conv"], xb, self.conv_w, self.conv_b, mesh)
            xc = conv_out.to(dt)
            y, state = _local_step(cache["state"], xc, *gates(xc),
                                   self.a_param, cfg.rglru.c, mesh)
            return y[:, None], {"conv": new_conv, "state": state}
        xc = _local_channels(_causal_conv, xb, (self.conv_w, self.conv_b),
                             mesh)
        y, state = _local_channels(
            lambda x_, a_, i_, p_: ops.rglru(x_, a_, i_, p_, c=cfg.rglru.c),
            xc, (*gates(xc), self.a_param), mesh, outs=2)
        if mode == "train":
            return y, None
        return y, {"conv": _local_tail(xb, cfg.rglru.d_conv - 1, mesh),
                   "state": state}


def _local_step(state, xc, a_gate, i_gate, a_param, c: float, mesh):
    """:func:`repro_torch.kernels.ops.rglru_decode_step` on each device's
    channels through ``local_map``: the state and the one token's xc and
    gates (B, W) split by W as the cache's state, ``a_param`` (W,) as
    its spec places it.  Returns ``(y placed as xc, state placed as the
    state)``."""
    from torch.distributed.tensor.experimental import local_map

    args = (state, xc, a_gate, i_gate, a_param)
    fn = local_map(functools.partial(ops.rglru_decode_step, c=c),
                   out_placements=(tuple(xc.placements),
                                   tuple(state.placements)),
                   in_placements=tuple(tuple(t.placements) for t in args),
                   device_mesh=mesh)
    return fn(*args)
