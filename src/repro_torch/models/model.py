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

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..configs.base import ArchConfig
from .common import DEFAULT_RULES, ShardingRules, resolve_specs
from .layers import MLA, MLP, Attention
from .moe import MoE
from .rglru import RGLRUBlock
from .ssm import SSDBlock
from .transformer import (Encoder, Model, MTPHead, count_params, forward,
                          model_flops)

__all__ = ["ModelBundle", "build", "loss_fn", "param_axes",
           "param_shapes"]


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

    @torch.no_grad()
    def prefill(self, params: Model, tokens, *, memory=None,
                cache_slots=None):
        """tokens (B, S), ``memory`` (B, T, M) frame or image embeddings
        where the config takes them -> (logits (B, S, V) float32,
        cache)."""
        out = forward(params, tokens, mode="prefill", cache_slots=cache_slots,
                      memory_inputs=memory)
        return out["logits"], out["cache"]

    @torch.no_grad()
    def decode_step(self, params: Model, cache, tokens, positions):
        """tokens (B, 1), positions (B, 1) -> (logits (B, 1, V), cache);
        the attention caches are updated in place."""
        out = forward(params, tokens, mode="decode", positions=positions,
                      cache=cache)
        return out["logits"], out["cache"]

    @staticmethod
    def concat_caches(caches: list):
        """Merge per-request caches along the batch axis (axis 0): every
        leaf, the cross layers' ``k`` / ``v`` and ``enc_memory``
        included."""
        if len(caches) == 1:
            return caches[0]

        def merge(*leaves):
            if isinstance(leaves[0], dict):
                return {k: merge(*(lf[k] for lf in leaves))
                        for k in leaves[0]}
            if isinstance(leaves[0], list):
                return [merge(*items) for items in zip(*leaves)]
            return torch.cat(leaves, dim=0)

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


def build(cfg: ArchConfig) -> ModelBundle:
    """The bundle of ``cfg``; an SSD pattern needs ``cfg.ssm``."""
    if "ssd" in cfg.pattern and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: an 'ssd' layer needs an SSMConfig")
    return ModelBundle(cfg)
