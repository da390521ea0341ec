"""The block-based decoder of the port: a list of blocks, each a mixer
(GQA attention or the Mamba-2 SSD) with an optional dense MLP, between
the embedding and the (tied) LM head.

Counterpart of ``repro/models/transformer.py`` for the modes ``train``
(dense GQA models), ``prefill`` and ``decode``.  The reference scans a
stacked layer axis; here the blocks are an ``nn.ModuleList`` and the
cache a list with one ``{"mixer": ...}`` entry per layer.  With
``cfg.remat`` each block trains under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant), the reference's
``jax.checkpoint`` of its scanned body: only block inputs are kept, and
the backward recomputes each block's forward.  ``layer_plan`` is kept so
that the reference's (prefix | scanned body | suffix) parameter trees
can be mapped onto the list (see :mod:`repro_torch.convert`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
            torch.ones((cfg.d_model,), dtype=torch.float32, device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _train_block(block: Block, h, positions, rope_tab):
    return block(h, mode="train", positions=positions, cache=None,
                 cache_slots=None, rope_tab=rope_tab)[0]


def forward(model: Model, tokens, *, mode: str = "prefill", positions=None,
            cache=None, cache_slots=None):
    """tokens: (B, S) integer tensor on the model's device.  mode
    'train', 'prefill' or 'decode' (then ``positions`` (B, 1) and the
    cache list are required).  Returns ``{"logits": (B, S, V) float32,
    "aux": 0.0 (no MoE is ported)}`` plus ``"cache": [per-layer {"mixer":
    ...}]`` outside training.  Training a model with SSD blocks raises
    ``NotImplementedError``: the SSD has no backward kernel."""
    cfg = model.cfg
    _, s = tokens.shape
    if mode == "train" and any(b.kind == "ssd" for b in model.blocks):
        raise NotImplementedError(
            f"{cfg.name}: training through the SSD has no backward kernel "
            f"(the reference has none either); see ROADMAP queue 1")
    h = F.embedding(tokens, model.embed).to(torch.bfloat16)
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    tab = (rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta,
                      tokens.device) if "attn" in cfg.pattern else None)
    new_cache = []
    for i, block in enumerate(model.blocks):
        if mode == "train":
            h = (checkpoint(_train_block, block, h, positions, tab,
                            use_reentrant=False) if cfg.remat
                 else _train_block(block, h, positions, tab))
            continue
        h, c = block(h, mode=mode, positions=positions,
                     cache=cache[i] if cache is not None else None,
                     cache_slots=cache_slots, rope_tab=tab)
        new_cache.append(c)
    hf = rms_norm(h, model.final_norm, cfg.norm_eps)
    head = (cast_weight(model, "embed", hf.dtype).T if cfg.tie_embeddings
            else cast_weight(model, "lm_head", hf.dtype))
    logits = (hf @ head).float()
    out = {"logits": logits,
           "aux": torch.zeros((), dtype=torch.float32, device=h.device)}
    if mode != "train":
        out["cache"] = new_cache
    return out

