"""The block-based decoder of the port: a list of blocks, each a mixer
(GQA attention or the Mamba-2 SSD) with an optional dense MLP, between
the embedding and the (tied) LM head.

Counterpart of ``repro/models/transformer.py`` for the serve modes
``prefill`` and ``decode``.  The reference scans a stacked layer axis;
here the blocks are an ``nn.ModuleList`` and the cache a list with one
``{"mixer": ...}`` entry per layer.  ``layer_plan`` is kept so that the
reference's (prefix | scanned body | suffix) parameter trees can be
mapped onto the list (see :mod:`repro_torch.convert`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .layers import (MLP, Attention, cast_weight, rms_norm, rope_table,
                     truncated_normal)
from .ssm import SSDBlock

__all__ = ["LayerPlan", "layer_plan", "Block", "Model", "forward"]


@dataclass(frozen=True)
class LayerPlan:
    kinds: tuple[str, ...]          # per-layer block kind
    has_moe: tuple[bool, ...]       # per-layer MoE flag
    prefix: int                     # unrolled leading layers
    period: int                     # scanned super-layer length
    reps: int                       # scan length
    suffix: int                     # unrolled trailing layers


def layer_plan(cfg: ArchConfig) -> LayerPlan:
    """The reference's grouping of the layers (same rules)."""
    kinds = []
    for i in range(cfg.n_layers):
        k = cfg.pattern[i % len(cfg.pattern)]
        if k == "attn" and cfg.encoder is not None:
            k = "dec_xattn"
        kinds.append(k)
    moe_flags = tuple(cfg.moe is not None and i >= cfg.moe.first_dense
                      and kinds[i] in ("attn", "dec_xattn", "xattn")
                      for i in range(cfg.n_layers))
    prefix = cfg.moe.first_dense if cfg.moe else 0
    period = len(cfg.pattern)
    if not cfg.scan_layers:
        return LayerPlan(tuple(kinds), moe_flags, cfg.n_layers, period, 0, 0)
    reps = (cfg.n_layers - prefix) // period
    suffix = cfg.n_layers - prefix - reps * period
    return LayerPlan(tuple(kinds), moe_flags, prefix, period, reps, suffix)


class Block(nn.Module):
    """One layer: ``mixer`` (Attention or SSDBlock) and, for attention
    layers with d_ff > 0, ``mlp``; both residual."""

    def __init__(self, cfg: ArchConfig, kind: str, *, device=None,
                 generator=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        if kind == "attn":
            self.mixer = Attention(cfg, device=device, generator=generator)
        elif kind == "ssd":
            self.mixer = SSDBlock(cfg, device=device, generator=generator)
        else:
            raise NotImplementedError(f"block kind {kind!r} is not ported")
        self.mlp = (MLP(cfg, device=device, generator=generator)
                    if kind != "ssd" and cfg.d_ff > 0 else None)

    def forward(self, h, *, mode, positions, cache, cache_slots,
                rope_tab=None):
        c_in = (cache or {}).get("mixer")
        if self.kind == "attn":
            out, c = self.mixer(h, positions=positions, mode=mode, cache=c_in,
                                window=self.cfg.window,
                                cache_slots=cache_slots, rope_tab=rope_tab)
        else:
            out, c = self.mixer(h, mode=mode, cache=c_in)
        h = h + out
        if self.mlp is not None:
            h = h + self.mlp(h)
        return h, {"mixer": c}


class Model(nn.Module):
    """Embedding (``embed`` (V, M), ``lm_head`` (M, V) unless tied), the
    blocks and ``final_norm`` (float32, as the reference's)."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = truncated_normal((cfg.vocab, cfg.d_model), dt, device,
                                      generator, scale=0.02)
        self.lm_head = (None if cfg.tie_embeddings else
                        truncated_normal((cfg.d_model, cfg.vocab), dt, device,
                                         generator))
        plan = layer_plan(cfg)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device=device, generator=generator)
            for kind in plan.kinds)
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), dtype=torch.float32, device=device),
            requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def forward(model: Model, tokens, *, mode: str = "prefill", positions=None,
            cache=None, cache_slots=None):
    """tokens: (B, S) integer tensor on the model's device.  mode
    'prefill' or 'decode' (then ``positions`` (B, 1) and the cache list
    are required).  Returns ``{"logits": (B, S, V) float32, "cache":
    [per-layer {"mixer": ...}]}``."""
    cfg = model.cfg
    _, s = tokens.shape
    h = F.embedding(tokens, model.embed).to(torch.bfloat16)
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    tab = (rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta,
                      tokens.device) if "attn" in cfg.pattern else None)
    new_cache = []
    for i, block in enumerate(model.blocks):
        h, c = block(h, mode=mode, positions=positions,
                     cache=cache[i] if cache is not None else None,
                     cache_slots=cache_slots, rope_tab=tab)
        new_cache.append(c)
    hf = rms_norm(h, model.final_norm, cfg.norm_eps)
    head = (cast_weight(model, "embed", hf.dtype).T if cfg.tie_embeddings
            else cast_weight(model, "lm_head", hf.dtype))
    logits = (hf @ head).float()
    return {"logits": logits, "cache": new_cache}

