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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from .transformer import Model, count_params, forward, model_flops

__all__ = ["ModelBundle", "build", "loss_fn"]


def _cross_entropy(logits, targets, mask):
    """mean over the mask of (logsumexp(logits) - logits[target]), in
    float32."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)


def loss_fn(cfg: ArchConfig, params: Model, batch) -> tuple:
    """Next-token cross-entropy plus the MoE layers' aux loss (0 for dense
    models) plus, for an MTP config, 0.3 times the MTP head's
    cross-entropy two tokens ahead: ``(loss, {"ce", "aux"[, "mtp"]})``.
    ``batch["tokens"]`` (B, S); the target of position i is token i + 1,
    the last position is masked (the last two for the MTP term), and
    ``ce = mean over the mask of (logsumexp(logits) - logits[target])``
    in float32.  A gather takes the place of the reference's one-hot
    contraction, which it equals (that form exists to keep vocab-sharded
    logits sharded).  ``batch["memory"]`` (B, T, M), where the config
    takes one, goes to the forward as its memory inputs."""
    tokens = batch["tokens"]
    out = forward(params, tokens, mode="train",
                  memory_inputs=batch.get("memory"))
    logits = out["logits"]
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=logits.device)
    mask[:, -1] = 0.0
    ce = _cross_entropy(logits, torch.roll(tokens, -1, dims=1).long(), mask)
    metrics = {"ce": ce, "aux": out["aux"]}
    loss = ce + out["aux"]
    if "mtp_logits" in out:
        mask2 = torch.ones_like(mask)
        mask2[:, -2:] = 0.0
        mtp = _cross_entropy(out["mtp_logits"],
                             torch.roll(tokens, -2, dims=1).long(), mask2)
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

    def loss(self, params: Model, batch):
        """:func:`loss_fn` of this bundle's config."""
        return loss_fn(self.cfg, params, batch)

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
