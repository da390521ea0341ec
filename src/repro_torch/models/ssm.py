"""Mamba-2 (SSD) mixer block of the port: in_proj -> causal depthwise conv
-> SiLU -> SSD -> gated RMSNorm -> out_proj.

Counterpart of ``repro/models/ssm.py``.  Prefill and training run the
SSD through the chunked-scan kernel (:func:`repro_torch.kernels.ops.ssd`),
which also returns the final state and is differentiable through its
backward kernel, at the chunk of the ``ssd_chunk`` perf flag where it
is set (else the config's; the kernels raise above 256); decode keeps ``{"conv": (B, d_conv - 1,
conv_dim), "state": (B, H, N, P)}`` and advances it one token in plain
torch, O(1) per token.  On a mesh (training, prefill and decode) see
:meth:`SSDBlock.forward`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops
from ..perf import flags
from .common import _names, axis_sizes
from .layers import (_book, batch_axes_for, batch_layout, branch_out,
                     cast_weight, constant, constrain, relayout, rms_norm,
                     truncated_normal)

__all__ = ["SSDBlock", "ssd_block_cache_shape"]


def _dims(cfg: ArchConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.n_groups * ssm.d_state
    return d_inner, n_heads, conv_dim


def ssd_block_cache_shape(cfg: ArchConfig, batch: int):
    ssm = cfg.ssm
    _, h, conv_dim = _dims(cfg)
    return {"conv": (batch, ssm.d_conv - 1, conv_dim),
            "state": (batch, h, ssm.d_state, ssm.head_dim)}


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise; left-padded causal, float32.
    Written as K shifted multiply-adds (no cuDNN, so no TF32)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = xp[:, 0:s] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * wf[i]
    return (out + b.float()).to(x.dtype)


def _local_channels(fn, x, params, mesh, *, outs: int = 1):
    """``fn(x, *params)`` on each device's block through ``local_map``,
    for a function elementwise in the channels: x (B, S, C) a DTensor
    over the batch axes and, by channel, over ``model`` or not;
    ``params`` per-channel weights placed as their specs place them
    (their last dim C as x's) or activations placed as x; the ``outs``
    outputs placed as x (a second one, a (B, C) final state, by x's
    batch and channel dims).  The gradient of a weight, replicated where
    x is split by batch, is a partial sum over the batch axes, which the
    train step reduces."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    xp = tuple(x.placements)
    pp = [tuple(p.placements) for p in params]
    grads = [tuple(Partial() if q.is_shard(0) and p.is_replicate() else p
                   for q, p in zip(xp, pl)) for pl in pp]
    state = tuple(Shard(1) if q == Shard(2) else q for q in xp)
    run = local_map(fn, out_placements=(xp,) if outs == 1 else (xp, state),
                    in_placements=(xp, *pp),
                    in_grad_placements=(xp, *grads), device_mesh=mesh)
    return run(x, *params)


def _tail(x, k: int):
    """The last k positions of x (B, S, C), left-padded with zeros where
    S < k: a prefill's conv cache."""
    return F.pad(x, (0, 0, max(0, k - x.shape[1]), 0))[:, -k:].contiguous()


def _local_tail(x, k: int, mesh):
    """:func:`_tail` of a DTensor x on each device's block (its sequence
    whole), placed as x."""
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(x.placements)
    return local_map(functools.partial(_tail, k=k), out_placements=(pl,),
                     in_placements=(pl,), device_mesh=mesh)(x)


def _conv_window(conv, x, w, b):
    """One token's causal depthwise conv: the cache's conv (B, K - 1, C)
    and x (B, 1, C) -> (the float32 output (B, C), the new conv (B, K -
    1, C))."""
    window = torch.cat([conv, x], dim=1)
    out = (window.float() * w.float()[None]).sum(1) + b.float()
    return out, window[:, 1:].contiguous()


def _local_conv_window(conv, x, w, b, mesh):
    """:func:`_conv_window` of DTensors on each device's channels through
    ``local_map``: x takes the cache conv's placements (a slice where the
    cache splits more: no bytes move), the weights (K, C) and (C,) are
    placed by channel as the cache (already so where the ``ff`` rule
    splits both); the output (B, C) is placed by the conv's batch and
    channel dims."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    cp = tuple(conv.placements)
    x = x if tuple(x.placements) == cp else x.redistribute(mesh, cp)
    chan = tuple(n for n, p in zip(mesh.mesh_dim_names, cp)
                 if p.is_shard(2)) or None
    w, b = relayout(w, mesh, (None, chan)), relayout(b, mesh, (chan,))
    out_pl = tuple(Shard(1) if p.is_shard(2) else p for p in cp)
    fn = local_map(_conv_window, out_placements=(out_pl, cp),
                   in_placements=(cp, cp, tuple(w.placements),
                                  tuple(b.placements)), device_mesh=mesh)
    return fn(conv, x, w, b)


def _local_ssd_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip, *, mesh):
    """:func:`repro_torch.kernels.ops.ssd_decode_step` on each device's
    block through ``local_map``: the state (B, H, N, P) placed by
    :func:`~repro_torch.models.model.cache_specs` (over the batch axes),
    the one token's x, dt, B and C by their batch dim, the per-head
    weights replicated.  Returns ``(y_t placed as x_t, new state placed
    as the state)``."""
    from torch.distributed.tensor.experimental import local_map

    args = (state, x_t, dt_t, a_log, b_t, c_t, d_skip)
    fn = local_map(ops.ssd_decode_step,
                   out_placements=(tuple(x_t.placements),
                                   tuple(state.placements)),
                   in_placements=tuple(tuple(t.placements) for t in args),
                   device_mesh=mesh)
    return fn(*args)


def _local_conv(x, w, b, *, mesh):
    """:func:`_causal_conv` of DTensors on each device's block: x's rows
    over the batch axes, the channels whole (:func:`_local_channels`)."""
    x = constrain(x, mesh, (tuple(n for n, p in zip(
        mesh.mesh_dim_names, x.placements) if p.is_shard(0)) or None,
        None, None))
    return _local_channels(_causal_conv, x, (w, b), mesh)


def _local_ssd(xs, dt, a_log, bmat, cmat, d_skip, mesh, *, chunk: int):
    """:func:`repro_torch.kernels.ops.ssd` (no initial state) on each
    device's block of DTensors, through ``local_map``: the batch over
    :func:`~repro_torch.models.layers.batch_axes_for`'s axes, the heads
    over ``model`` where their count divides it, B and C (shared by the
    heads of a group) and the per-head ``a_log`` and ``d_skip`` placed to
    match.  Gradients of what every device of a batch block shares are
    partial sums: B and C over ``model`` where the heads are split,
    ``a_log`` and ``d_skip`` over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    sizes = axis_sizes(mesh)
    n_heads = xs.shape[2]
    heads_ok = "model" in sizes and n_heads % sizes["model"] == 0
    bspec = batch_axes_for(mesh, xs.shape[0], heads_ok) or None
    hspec = "model" if (heads_ok and "model" not in (bspec or ())) else None
    xs = constrain(xs, mesh, (bspec, None, hspec, None))
    dt = constrain(dt, mesh, (bspec, None, hspec))
    bmat = constrain(bmat, mesh, (bspec, None, None, None))
    cmat = constrain(cmat, mesh, (bspec, None, None, None))
    a_log = relayout(a_log, mesh, (hspec,))
    d_skip = relayout(d_skip, mesh, (hspec,))
    names = mesh.mesh_dim_names
    batch_names = set(_names(bspec))
    bc_grad = tuple(Partial() if n == hspec else p
                    for n, p in zip(names, bmat.placements))
    head_grad = tuple(Partial() if n in batch_names else p
                      for n, p in zip(names, a_log.placements))
    state_pl = tuple(Shard(0) if n in batch_names else
                     Shard(1) if n == hspec else Replicate() for n in names)

    def run(x, t, a, bm, cm, d):
        _book("ssd", (*x.shape, *bm.shape[2:], chunk))
        return ops.ssd(x, t, a, bm, cm, d, chunk=chunk)

    fn = local_map(
        run, out_placements=(tuple(xs.placements), state_pl),
        in_placements=tuple(tuple(t.placements) for t in
                            (xs, dt, a_log, bmat, cmat, d_skip)),
        in_grad_placements=(tuple(xs.placements), tuple(dt.placements),
                            head_grad, bc_grad, bc_grad, head_grad),
        device_mesh=mesh)
    return fn(xs, dt, a_log, bmat, cmat, d_skip)


class SSDBlock(nn.Module):
    """Parameters as the reference's ``init_ssd_block``: ``norm``,
    ``in_proj`` (M, 2 d_inner + 2 G N + H), ``conv_w`` (d_conv,
    conv_dim), ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip`` (H,),
    ``gate_norm`` (d_inner,), ``out_proj`` (d_inner, M)."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        ssm = cfg.ssm
        m = cfg.d_model
        d_inner, h, conv_dim = _dims(cfg)
        d_in_proj = 2 * d_inner + 2 * ssm.n_groups * ssm.d_state + h
        dt = cfg.param_dtype
        self.cfg = cfg
        tn = functools.partial(truncated_normal, dtype=dt, device=device,
                               generator=generator)
        const = functools.partial(constant, dtype=dt, device=device)
        self.norm = const((m,), 1.0)
        self.in_proj = tn((m, d_in_proj))
        self.conv_w = tn((ssm.d_conv, conv_dim), fan_in_dims=(0,))
        self.conv_b = const((conv_dim,), 0.0)
        self.a_log = nn.Parameter(
            torch.log(torch.linspace(1.0, 16.0, h, device=device)).to(dt))
        self.dt_bias = const((h,), 0.0)
        self.d_skip = const((h,), 1.0)
        self.gate_norm = const((d_inner,), 1.0)
        self.out_proj = tn((d_inner, m))

    def forward(self, x, *, mode: str, cache=None, mesh=None):
        """mode 'prefill' (returns the cache; a given ``cache["state"]``
        is the scan's initial state), 'train' (the prefill's branch with
        no cache in or out, as in the reference) or 'decode' (S = 1,
        advances ``cache``).  ``mesh``: on a mesh, x and the weights
        DTensors.  Training and prefill gather the in_proj and conv
        weights and run the scan on each device's block
        (:func:`_local_ssd`); a prefill there starts from no state.
        Decode gathers the one token's in_proj product instead of the
        weight, runs the conv step on the cache's channel blocks
        (:func:`_local_conv_window`), gathers its output over the
        channels and advances the state on each device's rows
        (:func:`_local_ssd_step`).  Returns ``(y (B, S, M), cache)``, the
        cache None in training."""
        if mode not in ("prefill", "train", "decode"):
            raise ValueError(f"mode {mode!r}: 'prefill', 'train' or "
                             f"'decode'")
        if mesh is not None and mode == "prefill" and cache \
                and cache.get("state") is not None:
            raise NotImplementedError("a prefill on a mesh starts from no "
                                      "state")
        cfg, ssm = self.cfg, self.cfg.ssm
        b, s, _ = x.shape
        d_inner, h, conv_dim = _dims(cfg)
        gn = ssm.n_groups * ssm.d_state
        hidden = rms_norm(x, self.norm, cfg.norm_eps)
        w_in = cast_weight(self, "in_proj", hidden.dtype)
        conv_w, conv_b = self.conv_w, self.conv_b
        if mesh is not None and mode != "decode":
            # the in_proj columns and the conv channels split z, x B C
            # and dt at no boundary of theirs: gather the weights (a few
            # MB) rather than the activations, which the heads then
            # split again for free
            w_in, conv_w, conv_b = (relayout(w, mesh, (None,) * w.dim())
                                    for w in (w_in, conv_w, conv_b))
        zxbcdt = hidden @ w_in
        if mesh is not None and mode == "decode":
            # one token: its product's columns are fewer bytes than the
            # weight's
            zxbcdt = batch_layout(zxbcdt, mesh)
        z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, h], dim=-1)

        if mode == "decode":
            if mesh is None:
                conv_out, new_conv = _conv_window(cache["conv"], xbc,
                                                  conv_w, conv_b)
            else:
                conv_out, new_conv = _local_conv_window(
                    cache["conv"], xbc, conv_w, conv_b, mesh)
            xbc_act = F.silu(conv_out).to(x.dtype)[:, None]
            if mesh is not None:
                xbc_act = batch_layout(xbc_act, mesh)
        else:
            conv = _causal_conv if mesh is None else \
                functools.partial(_local_conv, mesh=mesh)
            xbc_act = F.silu(conv(xbc, conv_w, conv_b)
                             .float()).to(x.dtype)
            if mode == "prefill":
                new_conv = _tail(xbc, ssm.d_conv - 1) if mesh is None \
                    else _local_tail(xbc, ssm.d_conv - 1, mesh)

        xs, bmat, cmat = torch.split(xbc_act, [d_inner, gn, gn], dim=-1)
        xs = xs.reshape(b, -1, h, ssm.head_dim)
        bmat = bmat.reshape(b, -1, ssm.n_groups, ssm.d_state)
        cmat = cmat.reshape(b, -1, ssm.n_groups, ssm.d_state)
        dt = F.softplus(dt_raw.float() + self.dt_bias.float())

        if mode == "decode":
            step = ops.ssd_decode_step if mesh is None else \
                functools.partial(_local_ssd_step, mesh=mesh)
            y_t, new_state = step(cache["state"], xs[:, 0], dt[:, 0],
                                  self.a_log, bmat[:, 0], cmat[:, 0],
                                  self.d_skip)
            y = y_t[:, None]
        elif mesh is not None:
            y, new_state = _local_ssd(xs, dt, self.a_log, bmat, cmat,
                                      self.d_skip, mesh,
                                      chunk=flags().ssd_chunk or ssm.chunk)
        else:
            # a cache given at prefill seeds the scan's state, as in the
            # reference (its conv tail is not read there either)
            state_in = cache.get("state") if cache else None
            y, new_state = ops.ssd(xs, dt, self.a_log, bmat, cmat,
                                   self.d_skip,
                                   chunk=flags().ssd_chunk or ssm.chunk,
                                   state=state_in)
        new_cache = (None if mode == "train" else
                     {"conv": new_conv, "state": new_state})

        y = y.reshape(b, -1, d_inner)
        y = rms_norm(y * F.silu(z.float()).to(y.dtype), self.gate_norm,
                     cfg.norm_eps)
        return branch_out(y, cast_weight(self, "out_proj", y.dtype)), \
            new_cache
