"""RecurrentGemma / Griffin recurrent block of the port: linear -> causal
depthwise conv -> RG-LRU, gated by a GeLU branch, then the output
projection.

Counterpart of ``repro/models/rglru.py``.  The decode cache is ``{"conv":
(B, d_conv - 1, W), "state": (B, W) float32}``: O(1) a token.  The scan
and its one-token step are :func:`repro_torch.kernels.ops.rglru` and
``rglru_decode_step`` (plain torch; the reference has no kernel for them
either).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import cast_weight, constant, gelu, rms_norm, truncated_normal
from .ssm import _causal_conv

__all__ = ["RGLRUBlock"]


def _width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


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

    def forward(self, x, *, mode: str, cache=None):
        """mode 'train', 'prefill' (returns the cache; a given
        ``cache["state"]`` is the scan's initial state) or 'decode' (S =
        1, advances ``cache``).  Returns ``(y (B, S, M), cache)``, the
        cache None in training."""
        cfg = self.cfg
        s = x.shape[1]
        k = cfg.rglru.d_conv
        hidden = rms_norm(x, self.norm, cfg.norm_eps)
        dt = hidden.dtype
        xb = hidden @ cast_weight(self, "w_x", dt)
        gate = gelu(hidden @ cast_weight(self, "w_gate", dt))
        if mode == "decode":
            window = torch.cat([cache["conv"], xb], dim=1)   # (B, d_conv, W)
            xc = ((window.float() * self.conv_w.float()[None]).sum(1)
                  + self.conv_b.float()).to(x.dtype)
            y, state = ops.rglru_decode_step(
                cache["state"], xc, xc @ cast_weight(self, "w_a", dt),
                xc @ cast_weight(self, "w_i", dt), self.a_param,
                c=cfg.rglru.c)
            y = y[:, None]
            new_cache = {"conv": window[:, 1:].contiguous(), "state": state}
        elif mode in ("train", "prefill"):
            xc = _causal_conv(xb, self.conv_w, self.conv_b)
            y, state = ops.rglru(xc, xc @ cast_weight(self, "w_a", dt),
                                 xc @ cast_weight(self, "w_i", dt),
                                 self.a_param,
                                 state=(cache or {}).get("state"),
                                 c=cfg.rglru.c)
            tail = F.pad(xb, (0, 0, max(0, k - 1 - s), 0))[:, -(k - 1):]
            new_cache = ({"conv": tail.contiguous(), "state": state}
                         if mode == "prefill" else None)
        else:
            raise ValueError(f"mode {mode!r}: 'train', 'prefill' or "
                             f"'decode'")
        return (y * gate) @ cast_weight(self, "w_out", dt), new_cache
