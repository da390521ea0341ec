"""The block-based model of the port: a list of blocks, each a mixer
(GQA attention, MLA, the Mamba-2 SSD, the RG-LRU or gated
cross-attention) with an optional dense MLP or MoE, between the
embedding and the (tied) LM head; for an encoder-decoder config, the
bidirectional encoder over stub frame embeddings.

Counterpart of ``repro/models/transformer.py`` for the modes ``train``,
``prefill`` and ``decode``.  The reference scans a stacked layer axis;
here the blocks are an ``nn.ModuleList`` and the cache a list with one
``{"mixer": ...}`` entry per layer (``{"mixer", "cross"}`` for a decoder
layer with cross-attention), wrapped as ``{"layers": [...],
"enc_memory": ...}`` wherever a memory was attended.  With ``cfg.remat``
each block (and each encoder layer) trains under activation
checkpointing (``torch.utils.checkpoint``, non-reentrant), the
reference's ``jax.checkpoint`` of its scanned body: only block inputs
are kept, and the backward recomputes each block's forward.
``layer_plan`` is kept so that the reference's (prefix | scanned body |
suffix) parameter trees can be mapped onto the list (see
:mod:`repro_torch.convert`).  A config with ``mtp`` has the
multi-token-prediction head (``Model.mtp``): training runs it on the
last block's output and returns ``mtp_logits``, the prediction two
tokens ahead; serving never runs it, as in the reference.
``count_params`` and ``model_flops`` are the reference's config algebra
(6 N_active D a training step).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .common import axis_sizes, placements
from .layers import (MLA, MLP, Attention, batch_axes_for, cast_weight,
                     constrain, gather_fsdp, gather_seq, grad_layout,
                     local_embedding, replicated, rms_norm, rope_table,
                     truncated_normal)
from .moe import MoE
from .rglru import RGLRUBlock
from .ssm import SSDBlock

__all__ = ["LayerPlan", "layer_plan", "Block", "Encoder", "MTPHead",
           "Model", "forward", "layers_of", "place_cache",
           "count_params", "model_flops"]


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
    """One layer: ``mixer`` (Attention, MLA where the config has one,
    SSDBlock or RGLRUBlock; a cross Attention for ``xattn``), for
    ``dec_xattn`` a self-attention ``mixer`` followed by a cross
    Attention ``cross``, and, for every kind but ``ssd`` where the config
    has a feed-forward width, ``mlp`` (a MoE where ``use_moe``, else a
    dense MLP of ``cfg.d_ff``); all residual."""

    def __init__(self, cfg: ArchConfig, kind: str, use_moe: bool = False, *,
                 device=None, generator=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        mk = dict(device=device, generator=generator)
        if kind == "attn":
            self.mixer = (MLA(cfg, **mk) if cfg.mla is not None
                          else Attention(cfg, **mk))
        elif kind == "xattn":
            self.mixer = Attention(cfg, cross=True, **mk)
        elif kind == "dec_xattn":
            self.mixer = Attention(cfg, **mk)
            self.cross = Attention(cfg, cross=True, **mk)
        elif kind == "ssd":
            self.mixer = SSDBlock(cfg, **mk)
        elif kind == "rglru":
            self.mixer = RGLRUBlock(cfg, **mk)
        else:
            raise ValueError(f"block kind {kind!r}")
        d_ff = cfg.d_ff + (cfg.moe.d_ff_expert if cfg.moe else 0)
        self.mlp = None
        if kind != "ssd" and d_ff > 0:
            self.mlp = MoE(cfg, **mk) if use_moe else MLP(cfg, **mk)

    def forward(self, h, *, mode, positions, cache, cache_slots,
                rope_tab=None, memory=None, mesh=None):
        """Returns ``(h, cache, aux)``: the cache ``{"mixer": ...}``
        (plus ``"cross"`` for ``dec_xattn``), aux the MoE's weighted
        load-balancing loss in training, else None (and None without a
        MoE): serving reads no aux, so it computes none.  An ``xattn``
        layer given no memory runs as causal self-attention, with no
        window and a cache of the prompt's length, as the reference's
        does.  ``mesh``: on a mesh (every kind and mode); h leaves the block
        constrained as the reference's ``_apply_block`` leaves it
        (:meth:`_constrain`)."""
        cache = cache or {}
        c_in = cache.get("mixer")
        res = (lambda out: out) if mesh is None else \
            (lambda out: self._constrain(out, mode, mesh).to(h.dtype))
        if mesh is not None:
            h = self._constrain(h, mode, mesh)
        if self.kind == "xattn":
            out, c = self.mixer(h, positions=positions, mode=mode, cache=c_in,
                                rope_tab=rope_tab, memory=memory, mesh=mesh)
        elif isinstance(self.mixer, Attention):
            out, c = self.mixer(h, positions=positions, mode=mode, cache=c_in,
                                window=self.cfg.window,
                                cache_slots=cache_slots, rope_tab=rope_tab,
                                mesh=mesh)
        elif isinstance(self.mixer, MLA):
            out, c = self.mixer(h, positions=positions, mode=mode, cache=c_in,
                                cache_slots=cache_slots, rope_tab=rope_tab,
                                mesh=mesh)
        else:
            out, c = self.mixer(h, mode=mode, cache=c_in, mesh=mesh)
        h = h + res(out)
        new_cache = {"mixer": c}
        if self.kind == "dec_xattn":
            out, new_cache["cross"] = self.cross(
                h, positions=positions, mode=mode, cache=cache.get("cross"),
                rope_tab=rope_tab, memory=memory, mesh=mesh)
            h = h + res(out)
        aux = None
        if isinstance(self.mlp, MoE):
            out, aux = self.mlp(h, with_aux=mode == "train", mesh=mesh)
            h = h + res(out)
        elif self.mlp is not None:
            h = h + res(self.mlp(h))
        return h, new_cache, aux

    def _constrain(self, h, mode, mesh):
        """h (B, S, M) over the batch axes where they divide B (the
        model-parallel dim decides ``dp_over_model``: the SSD's heads,
        the RG-LRU's width, else the attention heads) and, for a
        ``seq_shard`` config in training, the sequence over ``model``
        between attention blocks (self or cross: Megatron sequence
        parallelism, the saved h shrinks by the model degree, and the
        all-gather / reduce-scatter pair sits at the block's entry and
        exit), replicated over the rest; the sequential mixers (SSD,
        RG-LRU) keep a batch-only layout, so a hybrid's layout changes
        at each switch between the kinds.  The block holds h there at
        its entry and each branch's output (a partial sum over ``model``
        where the branch's product is sharded) is reduced there before
        the residual add: an all-reduce, or a reduce-scatter under
        sequence parallelism.  The reference's rules
        (``_apply_block``)."""
        cfg = self.cfg
        sizes = axis_sizes(mesh)
        mp = sizes.get("model", 1)
        if self.kind == "ssd":
            div = ((cfg.ssm.expand * cfg.d_model)
                   // cfg.ssm.head_dim) % mp == 0
        elif self.kind == "rglru":
            div = (cfg.rglru.lru_width or cfg.d_model) % mp == 0
        else:
            div = cfg.n_heads % mp == 0
        batch_axes = batch_axes_for(mesh, h.shape[0], div) or None
        seq_ax = None
        if (cfg.seq_shard and mode == "train"
                and self.kind in ("attn", "xattn", "dec_xattn")
                and "model" in sizes and "model" not in (batch_axes or ())
                and h.shape[1] % sizes["model"] == 0):
            seq_ax = "model"
        return constrain(h, mesh, (batch_axes, seq_ax, None))


def _encoder_layer(block: Block, h, mesh=None):
    """One encoder layer: bidirectional attention, then the dense MLP.
    ``mesh``: on a mesh, h over the batch axes and replicated over
    ``model`` (the encoder has no sequence parallelism), each branch's
    partial sum over ``model`` reduced there before its residual add."""
    if mesh is None:
        h = h + block.mixer.encode(h)
        return h + block.mlp(h)
    res = lambda t: block._constrain(t, "encode", mesh).to(h.dtype)
    h = res(h)
    h = h + res(block.mixer.encode(h, mesh))
    return h + res(block.mlp(h))


class Encoder(nn.Module):
    """The bidirectional encoder of an encoder-decoder config (the
    reference's ``init_model`` ``encoder`` tree and ``_run_encoder``):
    ``adapter`` (M, M) float32, ``cfg.encoder.n_layers`` blocks of
    attention (its weights' layout, without rope or mask) and the dense
    MLP, and ``final_norm`` (M,) float32."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        enc_cfg = cfg.replace(pattern=("attn",), moe=None, mla=None,
                              encoder=None, n_layers=cfg.encoder.n_layers)
        self.cfg = enc_cfg
        self.blocks = nn.ModuleList(
            Block(enc_cfg, "attn", device=device, generator=generator)
            for _ in range(enc_cfg.n_layers))
        m = cfg.d_model
        self.adapter = truncated_normal((m, m), torch.float32, device,
                                        generator)
        self.final_norm = nn.Parameter(
            torch.ones((m,), dtype=torch.float32, device=device))

    def forward(self, frames, *, remat: bool = False, mesh=None):
        """frames (B, Sf, M) bf16 -> the memory (B, Sf, M) bf16; each
        layer under activation checkpointing where ``remat``.  ``mesh``:
        training on a mesh (the reference's ``_run_encoder`` there),
        frames a DTensor over the batch axes; the memory leaves over the
        batch axes, replicated over ``model``, and its gradient, the sum
        of the cross layers' partial sums over ``model``, is all-reduced
        once, in float32 (:func:`~repro_torch.models.layers.
        grad_layout`)."""
        h = frames @ cast_weight(self, "adapter", frames.dtype)
        for block in self.blocks:
            h = (checkpoint(_encoder_layer, block, h, mesh,
                            use_reentrant=False)
                 if remat else _encoder_layer(block, h, mesh))
        out = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return out if mesh is None else grad_layout(out)


class MTPHead(nn.Module):
    """The multi-token-prediction head (reference ``init_model``'s
    ``mtp``): ``proj`` (2 M, M) and ``norm`` (M,) float32 and ``block``,
    an attention layer (MLA where the config has it) with a dense MLP.
    Only training runs it."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        m = cfg.d_model
        self.proj = truncated_normal((2 * m, m), torch.float32, device,
                                     generator)
        self.block = Block(cfg.replace(moe=None), "attn", device=device,
                           generator=generator)
        self.norm = nn.Parameter(
            torch.ones((m,), dtype=torch.float32, device=device))

    def forward(self, h, tokens, embed, *, positions, rope_tab=None,
                mesh=None):
        """h (B, S, M): the last block's output before the final norm;
        tokens (B, S); ``embed`` the model's embedding.  Returns the
        block's output over ``[rms_norm(h, norm), embed[tokens shifted by
        one]] @ proj``, before the final norm (the reference's
        ``forward`` in training).  ``mesh``: on a mesh (DTensors), the
        next tokens' rows looked up vocab-parallel as the main
        embedding's (:func:`local_embedding`), h gathered over the
        sequence, and the block run with ``mesh``."""
        shifted = _roll_tokens(tokens, -1)
        if mesh is None:
            emb_next = F.embedding(shifted, embed).to(h.dtype)
        else:
            emb_next = _embed_on_mesh(shifted, embed, mesh)
        x = torch.cat([gather_seq(rms_norm(h, self.norm,
                                           self.block.cfg.norm_eps)),
                       emb_next], dim=-1) @ cast_weight(self, "proj",
                                                        h.dtype)
        out, _, _ = self.block(x, mode="train", positions=positions,
                               cache=None, cache_slots=None,
                               rope_tab=rope_tab, mesh=mesh)
        return out


class Model(nn.Module):
    """Embedding (``embed`` (V, M), ``lm_head`` (M, V) unless tied), the
    blocks (the MoE flags of :func:`layer_plan`: a leading ``first_dense``
    run of dense MLPs), ``final_norm`` (float32, as the reference's),
    for an encoder config ``encoder`` (:class:`Encoder`) and, for an
    ``mtp`` config, ``mtp`` (:class:`MTPHead`)."""

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
            Block(cfg, kind, use_moe, device=device, generator=generator)
            for kind, use_moe in zip(plan.kinds, plan.has_moe))
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), dtype=torch.float32, device=device))
        self.encoder = (Encoder(cfg, device=device, generator=generator)
                        if cfg.encoder is not None else None)
        self.mtp = (MTPHead(cfg, device=device, generator=generator)
                    if cfg.mtp else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _roll_tokens(tokens, shift: int):
    """``torch.roll(tokens, shift, dims=1)``; a DTensor's rows are rolled
    where they lie, whole on every device (the batch is split, never the
    sequence: DTensor has no rule for ``roll`` on torch 2.11)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tokens, DTensor):
        return torch.roll(tokens, shift, dims=1)
    return DTensor.from_local(torch.roll(tokens.to_local(), shift, dims=1),
                              tokens.device_mesh, tokens.placements,
                              run_check=False)


def _embed_on_mesh(tokens, embed, mesh):
    """The embedding lookup of DTensor tokens on a mesh: vocab-parallel
    (:func:`local_embedding`), its partial sums reduced to the batch
    layout in float32 (one nonzero term an entry: the sum is exact in any
    dtype; the reference's program reduces them in float32, a bf16
    table's too), then rounded to bf16."""
    h = local_embedding(tokens, gather_fsdp(embed), mesh).float()
    return constrain(h, mesh, (tuple(batch_axes_for(
        mesh, h.shape[0], True)) or None, None, None)).to(torch.bfloat16)


def _train_block(block: Block, h, positions, rope_tab, memory, mesh=None):
    h, _, aux = block(h, mode="train", positions=positions, cache=None,
                      cache_slots=None, rope_tab=rope_tab, memory=memory,
                      mesh=mesh)
    return h, aux


def _constrain_logits(logits, mesh):
    """Vocab-parallel logits (Megatron-style, the reference's
    ``_constrain_logits``): (B, S, V) float32 over the batch axes where
    they divide B and over ``model`` where it divides V."""
    sizes = axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    nb = 1
    for a in batch_axes:
        nb *= sizes[a]
    spec_b = batch_axes if (batch_axes and logits.shape[0] % nb == 0) \
        else None
    spec_v = "model" if ("model" in sizes
                         and logits.shape[-1] % sizes["model"] == 0) else None
    return constrain(logits, mesh, (spec_b, None, spec_v))


def layers_of(cache) -> list:
    """The per-layer entries of a cache (a list, or ``{"layers": [...],
    "enc_memory": ...}``)."""
    return cache["layers"] if isinstance(cache, dict) else cache


def _memory(model: Model, mode, cache, memory_inputs, mesh=None):
    """What the cross layers attend: the encoder's output over the frames
    (an encoder config), the image embeddings in bf16 or None (a vision
    config), or None; in decode the cache's ``enc_memory`` where it has
    one.  On a mesh ``memory_inputs`` is a DTensor over the batch axes
    (the train step's batch), and so is what the cross layers attend."""
    cfg = model.cfg
    if cfg.encoder is None and cfg.vision is None:
        return None
    if mode == "decode" and isinstance(cache, dict):
        return cache["enc_memory"]
    if memory_inputs is not None:
        memory_inputs = memory_inputs.to(torch.bfloat16)
    if cfg.encoder is None:
        return memory_inputs
    if memory_inputs is None:
        raise ValueError(
            f"{cfg.name}: the encoder's stub frontend needs memory inputs "
            f"(B, frames, d_model): pass memory_inputs")
    return model.encoder(memory_inputs, remat=cfg.remat and mode == "train",
                         mesh=mesh)


def forward(model: Model, tokens, *, mode: str = "prefill", positions=None,
            cache=None, cache_slots=None, memory_inputs=None, mesh=None):
    """tokens: (B, S) integer tensor on the model's device.  mode
    'train', 'prefill' or 'decode' (then ``positions`` (B, 1) and the
    cache are required).  ``memory_inputs``: the stub frontend's frame
    (encoder configs, required outside decode) or image (vision configs,
    optional) embeddings (B, T, M), cast to bf16; decode reads the memory
    from the cache.  Returns ``{"logits": (B, S, V) float32, "aux": the
    MoE layers' summed load-balancing loss in training (0 without MoE,
    and outside training)}`` plus ``"cache"`` outside training: the list
    of per-layer caches, or ``{"layers": [...], "enc_memory": (B, T, M)}``
    where a memory was attended.  Training an ``mtp`` config adds
    ``"mtp_logits"`` (B, S, V) float32: the MTP head's prediction of
    token i + 2, through the final norm and the head.

    ``mesh``: on a ``DeviceMesh``, the weights DTensors placed by their
    specs and ``tokens`` (and ``memory_inputs``, where the config takes
    them) DTensors over the batch axes; the rotary table and the aux
    accumulator become replicated DTensors, and the logits leave
    vocab-parallel (sharded over ``model`` where the vocabulary divides
    it) for :func:`~repro_torch.models.model.loss_fn` to take without
    gathering them.  Prefill and decode on a mesh (every family):
    ``tokens`` (and ``positions`` in decode, ``memory_inputs`` in
    prefill) may be the global tensors, which each rank cuts to its rows
    (:func:`_on_batch`); the encoder runs on the mesh without remat; each
    block holds h over the batch axes only, as the reference's
    ``_apply_block`` does outside training; a decode step's rotary table
    is formed on each device's rows and its memory is the cache's
    ``enc_memory``; the cache, in and out, is placed by
    :func:`~repro_torch.models.model.cache_specs` (:func:`place_cache`;
    ``enc_memory`` over the batch axes)."""
    cfg = model.cfg
    _, s = tokens.shape
    serve_mesh = mesh is not None and mode != "train"
    if serve_mesh:
        tokens = _on_batch(tokens, mesh)
        if memory_inputs is not None:
            memory_inputs = _on_batch(memory_inputs, mesh)
        if mode == "decode":
            positions = _on_batch(positions, mesh)
            cache = place_cache(cache, mesh)
    memory = _memory(model, mode, cache, memory_inputs, mesh)
    if mesh is None:
        h = F.embedding(tokens, model.embed).to(torch.bfloat16)
    else:
        h = _embed_on_mesh(tokens, model.embed, mesh)
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    # one rotary table serves every attention layer: at the head size, or
    # at MLA's rotated slice
    rope_d = cfg.mla.qk_rope if cfg.mla is not None else \
        cfg.resolved_head_dim
    tab = None
    if "attn" in cfg.pattern:
        tab = (_local_rope(positions, rope_d, cfg.rope_theta, mesh)
               if isinstance(positions, DTensor) else
               rope_table(positions, rope_d, cfg.rope_theta, tokens.device))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mesh is not None:
        if tab is not None and not isinstance(tab[0], DTensor):
            tab = tuple(replicated(t, mesh) for t in tab)
        aux = replicated(aux, mesh)
    layers_in = layers_of(cache) if cache is not None else None
    new_cache = []
    for i, block in enumerate(model.blocks):
        if mode == "train":
            h, a = (checkpoint(_train_block, block, h, positions, tab,
                               memory, mesh, use_reentrant=False)
                    if cfg.remat else
                    _train_block(block, h, positions, tab, memory, mesh))
            if a is not None:
                aux = aux + a
            continue
        h, c, _ = block(h, mode=mode, positions=positions,
                        cache=layers_in[i] if layers_in is not None else None,
                        cache_slots=cache_slots, rope_tab=tab, memory=memory,
                        mesh=mesh)
        new_cache.append(c)
    hf = gather_seq(rms_norm(h, model.final_norm, cfg.norm_eps))
    head = (cast_weight(model, "embed", hf.dtype).T if cfg.tie_embeddings
            else cast_weight(model, "lm_head", hf.dtype))
    logits = (hf @ head).float()
    if mesh is not None:
        logits = _constrain_logits(logits, mesh)
    out = {"logits": logits, "aux": aux}
    if mode == "train" and model.mtp is not None:
        mtp_h = model.mtp(h, tokens, model.embed, positions=positions,
                          rope_tab=tab, mesh=mesh)
        mtp_logits = (gather_seq(rms_norm(mtp_h, model.final_norm,
                                          cfg.norm_eps)) @ head).float()
        out["mtp_logits"] = (mtp_logits if mesh is None else
                             _constrain_logits(mtp_logits, mesh))
    if mode != "train":
        out["cache"] = (new_cache if memory is None else
                        {"layers": new_cache, "enc_memory": memory})
        if serve_mesh:
            out["cache"] = place_cache(out["cache"], mesh)
    return out


def _on_batch(t, mesh):
    """``t`` (B, ...) as a DTensor split by its rows over the batch axes
    where they divide B, replicated elsewhere: kept where it is a
    DTensor, else each rank takes its rows of the global tensor it holds
    (no bytes move)."""
    if isinstance(t, DTensor):
        return t
    from torch.distributed.tensor import distribute_tensor
    spec = (tuple(batch_axes_for(mesh, t.shape[0], True)) or None,) + \
        (None,) * (t.dim() - 1)
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def _local_rope(positions, d: int, theta: float, mesh):
    """:func:`~repro_torch.models.layers.rope_table` of DTensor positions
    (B, 1) on each device's rows: the table (B, 1, 1, d/2) placed by the
    positions' rows."""
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(positions.placements)
    fn = local_map(lambda p: rope_table(p, d, theta, p.device),
                   out_placements=(pl, pl), in_placements=(pl,),
                   device_mesh=mesh)
    return fn(positions)


def place_cache(cache, mesh):
    """A serve cache's leaves placed by :func:`~repro_torch.models.model.
    cache_specs` on ``mesh``: a DTensor redistributed to its spec (the
    layers' own layouts are the specs' but for a split that the spec
    adds, a slice), a plain tensor, the global leaf on every rank,
    cut to each rank's block."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._pytree import tree_map

    from .model import cache_specs

    def place(t, spec):
        if isinstance(t, DTensor):
            return constrain(t, mesh, spec)
        return distribute_tensor(t, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    return tree_map(place, cache, cache_specs(cache, mesh))


# ---------------------------------------------------------------------------
# Analytic parameters and FLOPs (6 N D dense, 6 N_active D MoE)
# ---------------------------------------------------------------------------


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """The reference's parameter count from the config alone (no
    allocation): the embedding and head, every mixer's and MLP's
    matrices, the routers and the encoder's layers; norms, gates, the
    encoder's adapter and the MTP head are not counted.  ``active_only``
    counts top_k routed experts a MoE layer instead of all of them."""
    m, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    glu = 3 if cfg.mlp_act.endswith("_glu") else 2
    attn = m * h * dh + 2 * m * hkv * dh + h * dh * m
    plan = layer_plan(cfg)
    total = v * m + (0 if cfg.tie_embeddings else m * v)
    for i, kind in enumerate(plan.kinds):
        if kind in ("attn", "dec_xattn"):
            if cfg.mla is not None:
                mla = cfg.mla
                qk = mla.qk_nope + mla.qk_rope
                total += (m * mla.q_lora + mla.q_lora * h * qk
                          + m * (mla.kv_lora + mla.qk_rope)
                          + mla.kv_lora * h * (mla.qk_nope + mla.v_head)
                          + h * mla.v_head * m)
            else:
                total += attn
            if kind == "dec_xattn":
                total += attn
        elif kind == "xattn":
            total += attn
        elif kind == "ssd":
            ssm = cfg.ssm
            d_inner = ssm.expand * m
            gn = ssm.n_groups * ssm.d_state
            nh = d_inner // ssm.head_dim
            total += m * (2 * d_inner + 2 * gn + nh) + d_inner * m
        elif kind == "rglru":
            w = cfg.rglru.lru_width or m
            total += 2 * m * w + 2 * w * w + w * m
        if plan.has_moe[i]:
            moe = cfg.moe
            n_e = moe.top_k if active_only else moe.n_experts
            total += 3 * moe.d_ff_expert * m * n_e + m * moe.n_experts
            total += 3 * moe.d_ff_expert * moe.n_shared * m
        elif kind in ("attn", "xattn", "dec_xattn", "rglru") and f > 0:
            total += glu * m * f
    if cfg.encoder is not None:
        total += cfg.encoder.n_layers * (attn + glu * m * f)
    return int(total)


def model_flops(cfg: ArchConfig, tokens: int, mode: str = "train") -> float:
    """6 N_active D for a training step over ``tokens`` tokens, 2
    N_active D for inference."""
    mult = 6.0 if mode == "train" else 2.0
    return mult * count_params(cfg, active_only=True) * tokens
