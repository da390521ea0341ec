"""Public model API of the port: ``build(cfg)`` -> ModelBundle with init,
loss, prefill, decode_step and concat_caches, and ``loss_fn``.

Counterpart of ``repro/models/model.py`` for all ten configs, the
memory-input families included: an encoder-decoder config (seamless)
takes frame embeddings and a vision config (llama-3.2-vision) image
embeddings as ``memory``; an MTP config (deepseek-v3) trains its MTP
head, whose cross-entropy two tokens ahead enters the loss at 0.3.
``params`` is the :class:`~repro_torch.models.transformer.
Model` (an ``nn.Module``).  The batch is axis 0 of every cache leaf
(the cross layers' ``k``, ``v`` and ``enc_memory`` too), so
``concat_caches`` concatenates there (the reference needs
``cache_logical_axes`` to find it under its stacked layer axis).
:func:`cache_logical_axes` and :func:`cache_specs` give a serve cache's
leaves the reference's axes and specs on a mesh; ``prefill`` and
``decode_step`` take a ``mesh`` as the reference's do, the weights
placed by :func:`place_params`.

:func:`param_axes` gives every parameter the logical axes that the
reference's ``box(...)`` calls give its weight, and
:meth:`ModelBundle.param_specs` resolves them onto a mesh.  The
reference stacks its scanned layers, so its body leaves have a leading
layer dim whose spec is ``None``; the port's layers are one module each,
and a parameter's spec is the reference leaf's without that dim.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..configs.base import ArchConfig
from .common import DEFAULT_RULES, ShardingRules, resolve_specs
from .layers import MLA, MLP, Attention
from .moe import MoE
from .rglru import RGLRUBlock
from .ssm import SSDBlock, ssd_block_cache_shape
from .transformer import (Encoder, Model, MTPHead, count_params, forward,
                          layer_plan, model_flops)

__all__ = ["ModelBundle", "build", "loss_fn", "param_axes",
           "param_shapes", "cache_logical_axes", "cache_specs",
           "place_params"]


def _leaf_axes(module, leaf: str) -> tuple:
    """The reference's logical axes of parameter ``leaf`` of ``module``
    (its ``init_*`` functions' ``box`` calls)."""
    cfg = getattr(module, "cfg", None)
    e = "fsdp" if cfg is not None and cfg.fsdp else None
    if isinstance(module, Model):
        table = {"embed": ("vocab", e), "lm_head": (e, "vocab"),
                 "final_norm": (None,)}
    elif isinstance(module, Attention):
        table = {"wq": (e, "heads", None), "wk": (e, "kv_heads", None),
                 "wv": (e, "kv_heads", None), "wo": ("heads", None, e),
                 "norm": (None,), "gate": ()}
    elif isinstance(module, MLA):
        table = {"wq_a": (e, None), "q_norm": (None,),
                 "wq_b": (None, "heads", None), "wkv_a": (e, None),
                 "kv_norm": (None,), "wkv_b": (None, "heads", None),
                 "wo": ("heads", None, e), "norm": (None,)}
    elif isinstance(module, MLP):
        table = {"norm": (None,), "w_gate": (e, "ff"), "w_up": (e, "ff"),
                 "w_down": ("ff", e)}
    elif isinstance(module, MoE):
        table = {"norm": (None,), "router": (None, None),
                 "w_gate": ("expert", None, "expert_ff"),
                 "w_up": ("expert", None, "expert_ff"),
                 "w_down": ("expert", "expert_ff", None)}
    elif isinstance(module, SSDBlock):
        table = {"norm": (None,), "in_proj": (e, "ff"),
                 "conv_w": ("conv", "ff"), "conv_b": ("ff",),
                 "a_log": (None,), "dt_bias": (None,), "d_skip": (None,),
                 "gate_norm": ("ff",), "out_proj": ("ff", e)}
    elif isinstance(module, RGLRUBlock):
        table = {"norm": (None,), "w_x": (e, "ff"), "w_gate": (e, "ff"),
                 "conv_w": ("conv", "ff"), "conv_b": ("ff",),
                 "w_a": ("ff", None), "w_i": ("ff", None),
                 "a_param": ("ff",), "w_out": ("ff", e)}
    elif isinstance(module, Encoder):
        table = {"adapter": (None, None), "final_norm": (None,)}
    elif isinstance(module, MTPHead):
        table = {"proj": (None, None), "norm": (None,)}
    else:
        raise KeyError(f"no logical axes for {type(module).__name__}")
    return table[leaf]


@functools.lru_cache(maxsize=None)
def _meta_params(cfg: ArchConfig) -> tuple:
    """``(name, shape, dtype, axes)`` of every parameter, from a model
    on the meta device (nothing allocated)."""
    model = Model(cfg, device="meta")
    out = []
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        axes = _leaf_axes(model.get_submodule(owner), leaf)
        assert len(axes) == p.dim(), (name, tuple(p.shape), axes)
        out.append((name, tuple(p.shape), p.dtype, axes))
    return tuple(out)


def param_axes(cfg: ArchConfig) -> dict:
    """``{parameter name: logical axes}``, one axis name (or None) per
    dim, as the reference's ``box`` calls give them."""
    return {name: axes for name, _, _, axes in _meta_params(cfg)}


def param_shapes(cfg: ArchConfig) -> dict:
    """``{parameter name: (shape, dtype)}`` of the global parameters."""
    return {name: (shape, dt) for name, shape, dt, _ in _meta_params(cfg)}


def _leaf_cache_axes(name: str, nd: int) -> tuple:
    """The reference's logical axes of a cache leaf by its name and rank
    (``cache_logical_axes``)."""
    if name in ("k", "v"):
        axes = ("batch", "kv_heads", "kv_seq", None)
    elif name == "kpos":
        axes = ("batch", "kv_seq")
    elif name in ("ckv", "krope"):
        axes = ("batch", "kv_seq", None)
    elif name == "conv":
        axes = ("batch", None, "ff")
    elif name == "state":
        axes = ("batch", None, None, None) if nd == 4 else ("batch", "ff")
    elif name == "enc_memory":
        axes = ("batch", None, None)
    else:
        axes = ("batch",) + (None,) * (nd - 1)
    if len(axes) != nd:
        raise ValueError(f"cache leaf {name!r} of rank {nd}: axes {axes}")
    return axes


def cache_logical_axes(cache):
    """The logical sharding axes of every leaf of a serve cache, by the
    leaf's name and rank, as the reference's ``cache_logical_axes``
    assigns them: ``k`` / ``v`` ``("batch", "kv_heads", "kv_seq",
    None)``, ``kpos`` ``("batch", "kv_seq")``, ``conv`` ``("batch", None,
    "ff")``, ``state`` ``("batch", None, None, None)`` at rank 4 (the
    SSD's) else ``("batch", "ff")`` (the RG-LRU's), ``ckv`` / ``krope``
    ``("batch", "kv_seq", None)``, ``enc_memory`` ``("batch", None,
    None)``, anything else the batch first.  The cache is the port's
    tree of tensors (a list of per-layer dicts, or ``{"layers": [...],
    "enc_memory": ...}``).  The port's layers are not stacked: every
    leaf has the batch at axis 0 and no layer axis to strip."""
    from torch.utils._pytree import tree_map_with_path

    return tree_map_with_path(
        lambda path, t: _leaf_cache_axes(path[-1].key, t.dim()), cache)


def cache_specs(cache, mesh, rules: ShardingRules = DEFAULT_RULES):
    """The spec of every leaf of a serve cache on ``mesh``:
    :func:`cache_logical_axes` resolved through ``rules`` at each leaf's
    shape (the reference's ``_output_shardings``: ``kv_seq`` is
    unsharded under the default rules; an axis whose mesh axes do not
    divide its dim falls back to replication)."""
    from torch.utils._pytree import tree_map_with_path

    return tree_map_with_path(
        lambda path, t: resolve_specs(_leaf_cache_axes(path[-1].key,
                                                       t.dim()),
                                      rules, mesh, tuple(t.shape)), cache)


def place_params(model: Model, mesh, rules: ShardingRules = DEFAULT_RULES
                 ) -> Model:
    """``model``'s parameters, in place, as DTensors on ``mesh`` placed by
    :meth:`ModelBundle.param_specs`: each rank holds the whole model and
    keeps its blocks (no bytes move).  Returns the model."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    from .common import placements

    specs = ModelBundle(model.cfg).param_specs(mesh, rules)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            distribute_tensor(p.detach(), mesh,
                              placements(specs[name], mesh),
                              src_data_rank=None),
            requires_grad=p.requires_grad)
    return model


def _cross_entropy(logits, targets, mask):
    """mean over the mask of (logsumexp(logits) - logits[target]), in
    float32."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)


def _sharded_cross_entropy(logits, tokens, mesh, shift: int = 1):
    """:func:`_cross_entropy` of DTensor logits (B, S, V), the last
    ``shift`` positions masked, without gathering them: each batch block
    sums its rows' cross-entropies, vocab-parallel over ``model``
    through ``loss_parallel`` on the model axis (the train step runs its
    backward under the same context) where the logits are sharded there;
    the block sums are added over the batch axes by one all-reduce of a
    scalar, and the sum is divided by the global count of unmasked
    targets.  Returns a replicated 0-d DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = mesh.mesh_dim_names
    pl = tuple(logits.placements)
    local = logits.to_local(grad_placements=pl)
    tok = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    targets = torch.roll(tok, -shift, dims=1).long()
    targets[:, -shift:] = -100
    md = names.index("model") if "model" in names else None
    if md is not None and pl[md] == Shard(2):
        lp = DTensor.from_local(local, mesh["model"], [Shard(2)],
                                run_check=False)
        block = F.cross_entropy(lp.flatten(0, 1), targets.flatten(),
                                ignore_index=-100, reduction="sum")
        block = block.to_local(grad_placements=[Replicate()])
    else:
        block = F.cross_entropy(local.flatten(0, 1), targets.flatten(),
                                ignore_index=-100, reduction="sum")
    total = DTensor.from_local(
        block, mesh, [Partial() if p == Shard(0) else Replicate()
                      for p in pl], run_check=False)
    total = total.redistribute(mesh, [Replicate()] * mesh.ndim)
    b, s = logits.shape[0], logits.shape[1]
    return total / float(b * (s - shift))


def loss_fn(cfg: ArchConfig, params: Model, batch, *, mesh=None) -> tuple:
    """Next-token cross-entropy plus the MoE layers' aux loss (0 for dense
    models) plus, for an MTP config, 0.3 times the MTP head's
    cross-entropy two tokens ahead: ``(loss, {"ce", "aux"[, "mtp"]})``.
    ``batch["tokens"]`` (B, S); the target of position i is token i + 1,
    the last position is masked (the last two for the MTP term), and
    ``ce = mean over the mask of (logsumexp(logits) - logits[target])``
    in float32.  A gather takes the place of the reference's one-hot
    contraction, which it equals (that form exists to keep vocab-sharded
    logits sharded).  ``batch["memory"]`` (B, T, M), where the config
    takes one, goes to the forward as its memory inputs.  ``mesh``:
    training on a mesh (``batch["tokens"]`` a DTensor over the batch
    axes, see :func:`~repro_torch.models.transformer.forward`); the
    cross-entropy then runs on the vocab-parallel logits
    (:func:`_sharded_cross_entropy`, the MTP term's too), the summed
    aux is a replicated scalar, and loss and metrics are replicated
    DTensors."""
    tokens = batch["tokens"]
    out = forward(params, tokens, mode="train",
                  memory_inputs=batch.get("memory"), mesh=mesh)
    logits = out["logits"]
    if mesh is not None:
        ce = _sharded_cross_entropy(logits, tokens, mesh)
    else:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=logits.device)
        mask[:, -1] = 0.0
        ce = _cross_entropy(logits, torch.roll(tokens, -1, dims=1).long(),
                            mask)
    metrics = {"ce": ce, "aux": out["aux"]}
    loss = ce + out["aux"]
    if "mtp_logits" in out:
        if mesh is not None:
            mtp = _sharded_cross_entropy(out["mtp_logits"], tokens, mesh,
                                         shift=2)
        else:
            mask2 = torch.ones_like(mask)
            mask2[:, -2:] = 0.0
            mtp = _cross_entropy(out["mtp_logits"],
                                 torch.roll(tokens, -2, dims=1).long(),
                                 mask2)
        metrics["mtp"] = mtp
        loss = loss + 0.3 * mtp
    return loss, metrics


@dataclass
class ModelBundle:
    cfg: ArchConfig

    def init(self, seed: int = 0, device=None) -> Model:
        """A model with random weights drawn from a ``torch.Generator``
        seeded with ``seed``, on ``device`` (default: the card)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return Model(self.cfg, device=device, generator=gen)

    def loss(self, params: Model, batch, *, mesh=None):
        """:func:`loss_fn` of this bundle's config."""
        return loss_fn(self.cfg, params, batch, mesh=mesh)

    def param_specs(self, mesh, rules: ShardingRules = DEFAULT_RULES
                    ) -> dict:
        """``{parameter name: spec}`` on ``mesh`` (the reference's
        ``param_specs`` without the stacked layer dim)."""
        return {name: resolve_specs(axes, rules, mesh, shape)
                for name, shape, _, axes in _meta_params(self.cfg)}

    def cache_shapes(self, batch: int, slots: int, memory_len=None):
        """The cache that a prefill of ``batch`` rows with ``cache_slots=
        slots`` returns, as meta tensors (shape and dtype, nothing
        allocated): per layer ``{"mixer": ...}``, an attention layer's
        ``k`` / ``v`` (B, Hkv, slots, D) bf16 and ``kpos`` (B, slots)
        int32, MLA's ``ckv`` (B, slots, kv_lora) and ``krope`` (B, slots,
        qk_rope) bf16, an SSD layer's ``conv`` (B, d_conv - 1, conv_dim)
        bf16 and ``state`` (B, H, N, P) float32, an RG-LRU layer's
        ``conv`` (B, d_conv - 1, W) bf16 and ``state`` (B, W) float32, a
        cross layer's ``k`` / ``v`` (B, max(1, Hkv), T, D) bf16 at the
        memory's length ``memory_len`` = T (no ``kpos``); a ``dec_xattn``
        layer's ``{"mixer": self-attention, "cross": cross}``.  A config
        that takes a memory (an encoder or a vision config) needs
        ``memory_len``, and its cache is ``{"layers": [...],
        "enc_memory": (B, T, M) bf16}``."""
        cfg = self.cfg
        meta = functools.partial(torch.empty, device="meta")
        bf16 = torch.bfloat16
        takes_memory = cfg.encoder is not None or cfg.vision is not None
        if takes_memory and memory_len is None:
            raise ValueError(f"{cfg.name}: the cache of a memory config "
                             f"needs memory_len")
        dh = cfg.resolved_head_dim

        def attn(n_slots, kpos=True):
            heads = cfg.n_kv_heads if kpos else max(1, cfg.n_kv_heads)
            kv = (batch, heads, n_slots, dh)
            c = {"k": meta(kv, dtype=bf16), "v": meta(kv, dtype=bf16)}
            if kpos:
                c["kpos"] = meta((batch, n_slots), dtype=torch.int32)
            return c

        out = []
        for kind in layer_plan(cfg).kinds:
            if kind == "attn" and cfg.mla is not None:
                mla = cfg.mla
                layer = {"mixer": {
                    "ckv": meta((batch, slots, mla.kv_lora), dtype=bf16),
                    "krope": meta((batch, slots, mla.qk_rope), dtype=bf16)}}
            elif kind == "attn":
                layer = {"mixer": attn(slots)}
            elif kind == "xattn":
                layer = {"mixer": attn(memory_len, kpos=False)}
            elif kind == "dec_xattn":
                layer = {"mixer": attn(slots),
                         "cross": attn(memory_len, kpos=False)}
            elif kind == "ssd":
                shapes = ssd_block_cache_shape(cfg, batch)
                layer = {"mixer": {
                    "conv": meta(shapes["conv"], dtype=bf16),
                    "state": meta(shapes["state"], dtype=torch.float32)}}
            elif kind == "rglru":
                w = cfg.rglru.lru_width or cfg.d_model
                layer = {"mixer": {
                    "conv": meta((batch, cfg.rglru.d_conv - 1, w),
                                 dtype=bf16),
                    "state": meta((batch, w), dtype=torch.float32)}}
            else:
                raise ValueError(f"{cfg.name}: block kind {kind!r}")
            out.append(layer)
        if not takes_memory:
            return out
        return {"layers": out, "enc_memory": meta(
            (batch, memory_len, cfg.d_model), dtype=bf16)}

    @torch.no_grad()
    def prefill(self, params: Model, tokens, *, memory=None,
                cache_slots=None, mesh=None):
        """tokens (B, S), ``memory`` (B, T, M) frame or image embeddings
        where the config takes them -> (logits (B, S, V) float32,
        cache).  ``mesh``: on a ``DeviceMesh`` (the weights DTensors
        placed by :meth:`param_specs`, :func:`place_params`; tokens a
        DTensor over the batch axes, or the global tensor on every rank):
        the logits leave vocab-parallel and the cache placed by
        :func:`cache_specs`."""
        out = forward(params, tokens, mode="prefill", cache_slots=cache_slots,
                      memory_inputs=memory, mesh=mesh)
        return out["logits"], out["cache"]

    @torch.no_grad()
    def decode_step(self, params: Model, cache, tokens, positions, *,
                    mesh=None):
        """tokens (B, 1), positions (B, 1) -> (logits (B, 1, V), cache);
        the attention caches are updated in place.  ``mesh``: as
        :meth:`prefill`; the cache's leaves are placed by
        :func:`cache_specs` first."""
        out = forward(params, tokens, mode="decode", positions=positions,
                      cache=cache, mesh=mesh)
        return out["logits"], out["cache"]

    @staticmethod
    def concat_caches(caches: list):
        """Merge per-request caches along the batch axis (axis 0): every
        leaf, the cross layers' ``k`` / ``v`` and ``enc_memory``
        included.  DTensor leaves of one placement whose batch no mesh
        dim splits (a request's prefill of one row) are concatenated on
        each device's blocks (no bytes move); the merged cache's leaves
        keep that placement (a decode step places them by
        :func:`cache_specs`)."""
        if len(caches) == 1:
            return caches[0]

        def merge(*leaves):
            if isinstance(leaves[0], dict):
                return {k: merge(*(lf[k] for lf in leaves))
                        for k in leaves[0]}
            if isinstance(leaves[0], list):
                return [merge(*items) for items in zip(*leaves)]
            return _cat_rows(leaves)

        return merge(*caches)

    @staticmethod
    def num_params(params: Model) -> int:
        """The parameters counted from the model's tensors."""
        return sum(p.numel() for p in params.parameters())

    def num_active_params(self) -> int:
        """:func:`count_params` with top_k routed experts a MoE layer."""
        return count_params(self.cfg, active_only=True)

    def flops(self, tokens: int, mode: str = "train") -> float:
        """:func:`model_flops`: 6 N_active D a training step."""
        return model_flops(self.cfg, tokens, mode)


def _cat_rows(leaves):
    """``torch.cat(leaves, 0)``; DTensors of one placement that does not
    split dim 0 on their blocks (see :meth:`ModelBundle.concat_caches`)."""
    from torch.distributed.tensor import DTensor

    first = leaves[0]
    if not isinstance(first, DTensor):
        return torch.cat(leaves, dim=0)
    pl = tuple(first.placements)
    if any(tuple(t.placements) != pl for t in leaves) or any(
            p.is_shard(0) for p in pl):
        raise ValueError(f"concat_caches: DTensor leaves of placements "
                         f"{[tuple(t.placements) for t in leaves]}: one "
                         f"placement whose batch is whole is needed")
    local = torch.cat([t.to_local() for t in leaves], dim=0)
    shape = (sum(t.shape[0] for t in leaves), *first.shape[1:])
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local, first.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def build(cfg: ArchConfig) -> ModelBundle:
    """The bundle of ``cfg``; an SSD pattern needs ``cfg.ssm``."""
    if "ssd" in cfg.pattern and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: an 'ssd' layer needs an SSMConfig")
    return ModelBundle(cfg)
