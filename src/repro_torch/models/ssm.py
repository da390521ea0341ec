"""Mamba-2 (SSD) mixer block of the port: in_proj -> causal depthwise conv
-> SiLU -> SSD -> gated RMSNorm -> out_proj.

Counterpart of ``repro/models/ssm.py``.  Prefill and training run the
SSD through the chunked-scan kernel (:func:`repro_torch.kernels.ops.ssd`),
which also returns the final state and is differentiable through its
backward kernel, at the chunk of the ``ssd_chunk`` perf flag where it
is set (else the config's; the kernels raise above 256); decode keeps ``{"conv": (B, d_conv - 1,
conv_dim), "state": (B, H, N, P)}`` and advances it one token in plain
torch, O(1) per token.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops
from ..perf import flags
from .layers import cast_weight, constant, rms_norm, truncated_normal

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

    def forward(self, x, *, mode: str, cache=None):
        """mode 'prefill' (returns the cache; a given ``cache["state"]``
        is the scan's initial state), 'train' (the prefill's branch with
        no cache in or out, as in the reference) or 'decode' (S = 1,
        advances ``cache``).  Returns ``(y (B, S, M), cache)``, the cache
        None in training."""
        cfg, ssm = self.cfg, self.cfg.ssm
        b, s, _ = x.shape
        d_inner, h, conv_dim = _dims(cfg)
        gn = ssm.n_groups * ssm.d_state
        hidden = rms_norm(x, self.norm, cfg.norm_eps)
        zxbcdt = hidden @ cast_weight(self, "in_proj", hidden.dtype)
        z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, h], dim=-1)

        if mode == "decode":
            window = torch.cat([cache["conv"], xbc], dim=1)  # (B, d_conv, C)
            conv_out = (window.float() * self.conv_w.float()[None]).sum(1) \
                + self.conv_b.float()
            xbc_act = F.silu(conv_out).to(x.dtype)[:, None]
            new_conv = window[:, 1:]
        elif mode in ("prefill", "train"):
            xbc_act = F.silu(_causal_conv(xbc, self.conv_w, self.conv_b)
                             .float()).to(x.dtype)
            if mode == "prefill":
                pad = max(0, ssm.d_conv - 1 - s)
                new_conv = F.pad(xbc, (0, 0, pad, 0))[:, -(ssm.d_conv - 1):]
        else:
            raise ValueError(f"mode {mode!r}: 'prefill', 'train' or "
                             f"'decode'")

        xs, bmat, cmat = torch.split(xbc_act, [d_inner, gn, gn], dim=-1)
        xs = xs.reshape(b, -1, h, ssm.head_dim)
        bmat = bmat.reshape(b, -1, ssm.n_groups, ssm.d_state)
        cmat = cmat.reshape(b, -1, ssm.n_groups, ssm.d_state)
        dt = F.softplus(dt_raw.float() + self.dt_bias.float())

        if mode == "decode":
            y_t, new_state = ops.ssd_decode_step(
                cache["state"], xs[:, 0], dt[:, 0], self.a_log, bmat[:, 0],
                cmat[:, 0], self.d_skip)
            y = y_t[:, None]
        else:
            # a cache given at prefill seeds the scan's state, as in the
            # reference (its conv tail is not read there either)
            state_in = cache.get("state") if cache else None
            y, new_state = ops.ssd(xs, dt, self.a_log, bmat, cmat,
                                   self.d_skip,
                                   chunk=flags().ssd_chunk or ssm.chunk,
                                   state=state_in)
        new_cache = (None if mode == "train" else
                     {"conv": new_conv.contiguous(), "state": new_state})

        y = y.reshape(b, -1, d_inner)
        y = rms_norm(y * F.silu(z.float()).to(y.dtype), self.gate_norm,
                     cfg.norm_eps)
        return y @ cast_weight(self, "out_proj", y.dtype), new_cache
