"""Mixture-of-Experts block of the port: a top-k router over E experts,
each a SiLU-GLU MLP, and the shared (always-on) experts where the config
has them.

Counterpart of ``repro/models/moe.py`` on one card.  With no mesh the
reference runs ``_dense_path``: every expert on every token, weighted by
the top-k mask, so y = sum_e w_e(t) MLP_e(x_t).  The port computes the
same function in the reference's scatter form (``_global_scatter_path``)
with a capacity of T rows per expert: token t's pick of expert e goes to
row t of e's bin.  A token picks an expert at most once, so no bin
overflows and nothing is dropped.  (The reference packs each bin by a
running count of its picks instead; that cumulative sum over the (T k,
E) one-hot ran as one scan kernel of 2.4 ms a layer on an H100 at T =
1536, half a prefill's device time.)  The experts then run as three
batched products over the (E, T, M) bins, and each token gathers its k
outputs back to (T, k, M) and sums them, weighted, in float32 in a fixed
order (no float atomics, so a repeated call gives the same bits).  The
launches per layer are fixed and nothing is read back to the host.  The
bins hold E/k times the routed rows; a dispatch sized by the real counts
is later work.

The block reads no perf flag.  The reference reads ``bf16_experts`` in
``_expert_mlp_any`` (``repro/models/moe.py:90-107``), which only its
scatter and all-to-all paths call (``:155``, ``:194``), and ``moe_3d``
in the mesh dispatch (``:238``); with one device ``apply_moe`` runs
``_dense_path`` (``:266-270``), so neither changes a bit there, and the
port's bins already run in the activation dtype.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .layers import MLP, cast_weight, constant, rms_norm, truncated_normal

__all__ = ["MoE", "router_topk", "moe_aux_loss"]


def router_topk(cfg: ArchConfig, logits):
    """Top-k gating with renormalised weights.  logits (T, E) -> ``(probs
    (T, E), top_w (T, k), top_idx (T, k))``, float32.  The top k come from
    a stable descending sort, so ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them."""
    k = cfg.moe.top_k
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_w, top_idx


def moe_aux_loss(probs, top_idx, n_experts: int):
    """Switch-style load-balancing loss: E * sum_e f_e p_e, f_e the share
    of tokens whose first pick is e, p_e the mean router probability."""
    assign = F.one_hot(top_idx[:, 0], n_experts).float()
    return n_experts * (assign.mean(0) * probs.mean(0)).sum()


class MoE(nn.Module):
    """Parameters as the reference's ``init_moe``: ``norm`` (M,),
    ``router`` (M, E), ``w_gate`` / ``w_up`` (E, M, F), ``w_down`` (E, F,
    M) and, where ``n_shared > 0``, ``shared``: a SiLU-GLU :class:`MLP` of
    width F * n_shared applied to the normed input (its own ``norm`` is
    carried unused, as there)."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        moe = cfg.moe
        m, f, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
        dt = cfg.param_dtype
        self.cfg = cfg
        tn = functools.partial(truncated_normal, dtype=dt, device=device,
                               generator=generator)
        self.norm = constant((m,), 1.0, dt, device)
        self.router = tn((m, e))
        self.w_gate = tn((e, m, f), fan_in_dims=(1,))
        self.w_up = tn((e, m, f), fan_in_dims=(1,))
        self.w_down = tn((e, f, m), fan_in_dims=(1,))
        self.shared = (MLP(cfg.replace(mlp_act="silu_glu"),
                           d_ff=f * moe.n_shared, device=device,
                           generator=generator)
                       if moe.n_shared else None)

    def forward(self, x, with_aux: bool = True):
        """x (B, S, M) -> ``(y (B, S, M), aux loss x router_aux_weight)``,
        the aux None unless ``with_aux`` (serving reads none)."""
        cfg, moe = self.cfg, self.cfg.moe
        b, s, m = x.shape
        h = rms_norm(x, self.norm, cfg.norm_eps)
        x2d = h.reshape(b * s, m)
        logits = x2d @ cast_weight(self, "router", x2d.dtype)
        probs, top_w, top_idx = router_topk(cfg, logits)
        y = self.route(x2d, top_w, top_idx).view(b, s, m)
        if self.shared is not None:
            y = y + self.shared(h, skip_norm=True)
        if not with_aux:
            return y, None
        aux = moe_aux_loss(probs, top_idx, moe.n_experts)
        return y, aux * moe.router_aux_weight

    def route(self, x2d, top_w, top_idx):
        """sum_j top_w[t, j] MLP_{top_idx[t, j]}(x2d[t]) for x2d (T, M),
        through bins of T rows per expert; in x2d's dtype."""
        t, m = x2d.shape
        k = top_idx.shape[1]
        flat_e = top_idx.reshape(-1)
        flat_t = torch.arange(t, device=x2d.device).repeat_interleave(k)
        # each row repeated k times by a broadcast, not a gather: the
        # gradient sums the k copies as a reduction in a fixed order (a
        # gather's backward adds them with atomics, in any order on the
        # card), so a train step gives the same bits every time
        rows = x2d[:, None, :].expand(t, k, m).reshape(t * k, m)
        bins = x2d.new_zeros((self.cfg.moe.n_experts, t, m)).index_put_(
            (flat_e, flat_t), rows)
        dt = x2d.dtype
        # F.silu rounds once, where layers.silu rounds every step as the
        # reference does: its four more passes would run over bins of
        # E/k times the routed rows, and on an H100 they moved granite's
        # batched decode a bf16 step (0.0625) off its solo run, past the
        # serving rule's 0.05
        hidden = F.silu(torch.bmm(bins, cast_weight(self, "w_gate", dt))) \
            * torch.bmm(bins, cast_weight(self, "w_up", dt))
        out = torch.bmm(hidden, cast_weight(self, "w_down", dt))
        picked = out[flat_e, flat_t].view(t, k, m).float()
        return (picked * top_w[..., None]).sum(1).to(dt)
