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

With no mesh the block reads no perf flag.  The reference reads
``bf16_experts`` in ``_expert_mlp_any`` (``repro/models/moe.py:90-107``),
which only its scatter and all-to-all paths call (``:155``, ``:194``),
and ``moe_3d`` in the mesh dispatch (``:238``); with one device
``apply_moe`` runs ``_dense_path`` (``:266-270``), so neither changes a
bit there, and the port's bins already run in the activation dtype.

On a mesh (``MoE.forward(..., mesh=...)``, a ``DeviceMesh``; training)
the block dispatches as the reference's ``apply_moe`` (``:209-272``):

* where the mesh has ``model``, more than one device and B S divides
  over the devices, the expert-parallel all-to-all path: each device's
  block of tokens goes through :func:`a2a_body` (the reference's
  ``_a2a_body``, ``:122-171``) by ``local_map``.  Under the ``moe_3d``
  flag (the default) the tokens enter in the residual's own layout,
  batch over ``pod`` / ``data`` and sequence over ``model``, where
  those divide B and S, and are flattened inside the body; otherwise
  the flattened (B S, M) tokens are sharded over every axis in mesh
  order (DTensor's ``Shard(0)`` on each mesh dim, the reference's
  ``P(all_axes)``);
* elsewhere on a mesh of more than one device,
  :func:`_global_scatter_path` on the replicated tokens and weights
  (the reference's ``:174-198``, which GSPMD places);
* the shared expert is added after either path, its partial sums over
  ``model`` reduced in float32 to the routed output's layout.

A mesh path that cannot run raises; none falls back to the one-card
route.  The experts are padded with zero experts to ``E_pad``, the next
multiple of the ``model`` axis (granite's 40 become 48 on 16), and the
router stays over the real experts.  Where the expert count does not
divide ``model`` the weights are replicated over it (the reference's
rules drop the assignment), and each device pads them and takes its
``E_pad / model`` experts, so their gradient is a partial sum over
``model``.  Capacity overflow drops, as in the reference: C = ceil(t_loc
k / E x capacity_factor) rows a bin, t_loc the device's tokens.  The
picks are combined in float32 in a fixed order, as on one card (no
float atomics), where the reference adds bf16 rows by a scatter.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..perf import flags
from .common import axis_sizes
from .layers import (MLP, cast_weight, constant, constrain, gather_seq,
                     rms_norm, truncated_normal)

__all__ = ["MoE", "router_topk", "moe_aux_loss", "capacity", "slot_rule",
           "dispatch", "combine", "expert_mlp", "a2a_body", "Exchange",
           "expert_pad", "_global_scatter_path"]


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


# ---------------------------------------------------------------------------
# Capacity bins: the reference's scatter and all-to-all dispatch
# ---------------------------------------------------------------------------


def capacity(t: int, moe) -> int:
    """Rows of each expert's bin for ``t`` tokens: ceil(t k / E x
    capacity_factor), at least 1 (the reference's expression, in its
    order)."""
    return max(1, int(math.ceil(t * moe.top_k / moe.n_experts
                                * moe.capacity_factor)))


def slot_rule(top_idx, n_bins: int, cap: int):
    """``(slot, keep)``, each (T k,): every pick's position in its
    expert's bin by a running count over the flat (t, k) order, and
    whether it falls below the capacity ``cap`` (picks at or past it are
    dropped).  The count is the reference's cumulative sum over the
    one-hot (T k, E), taken here from a stable sort of the picks by
    expert: a pick's slot is its rank among its expert's picks."""
    flat_e = top_idx.reshape(-1)
    n = flat_e.numel()
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.bincount(flat_e, minlength=n_bins)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=flat_e.device) - starts[flat_e[order]]
    slot = torch.empty_like(flat_e).scatter_(0, order, rank)
    return slot, slot < cap


def dispatch(x, top_idx, slot, keep, n_bins: int, cap: int):
    """``(bins (n_bins, cap, M), index (T k,))``: each kept pick's token
    row of x (T, M) at its expert's ``slot``, zeros elsewhere; ``index``
    the pick's flat row of the bins, ``n_bins * cap`` (a dump row past
    them) for a dropped pick.  The reference adds every pick at
    ``(e, slot if kept else 0)`` with a zero row for a dropped one; a
    write with no accumulation would let that zero row overwrite a kept
    row at slot 0, so dropped picks go to the dump row, which is cut
    off.  The rows are x repeated k times by a broadcast (their gradient
    is a reduction in a fixed order, not atomics)."""
    t, m = x.shape
    k = top_idx.shape[1]
    dump = n_bins * cap
    index = torch.where(keep, top_idx.reshape(-1) * cap + slot, dump)
    rows = x[:, None, :].expand(t, k, m).reshape(t * k, m)
    bins = x.new_zeros((dump + 1, m)).index_put_((index,), rows)
    return bins[:dump].view(n_bins, cap, m), index


def combine(back, index, top_w, keep):
    """sum_j keep top_w[t, j] back[pick (t, j)] for bins ``back`` (n_bins,
    cap, M) and the picks' flat rows ``index`` (:func:`dispatch`): the k
    picks of each token weighted and summed in float32 in a fixed order,
    in back's dtype."""
    t, k = top_w.shape
    m = back.shape[-1]
    flat = torch.cat([back.reshape(-1, m), back.new_zeros((1, m))])
    picked = flat[index].view(t, k, m).float()
    w = top_w.float() * keep.view(t, k)
    return (picked * w[..., None]).sum(1).to(back.dtype)


def _no_tf32():
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("expert_mlp's float32 products need float32 "
                           "matmul precision 'highest' (TF32 is allowed)")


class _Bf16Product(torch.autograd.Function):
    """``a @ b`` (batched) of bf16 operands, summed and returned in
    float32: on the card cuBLAS's bf16 product with a float32 output
    (``torch.bmm(..., out_dtype=torch.float32)``), on the CPU the float32
    product of the bf16 values (each product of two bf16 values is exact
    in float32).  The backward rounds the float32 gradient to bf16 and
    takes both products the same way, each cast to its operand's
    dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bf16_bmm(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        return (_bf16_bmm(g, b.mT).to(a.dtype),
                _bf16_bmm(a.mT, g).to(b.dtype))


def _bf16_bmm(a, b):
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def expert_mlp(x, w_gate, w_up, w_down):
    """x (E, C, M) through each expert's SiLU-GLU MLP, batched (the
    reference's ``_expert_mlp_any``), in float32.  The ``bf16_experts``
    perf flag off: float32 operands and float32 products; they run at
    float32 precision, not TF32, and the function raises where PyTorch's
    float32 matmul precision is not ``highest`` or TF32 is allowed, so a
    setting made elsewhere cannot let TF32 in.  On: bf16 operands summed
    in float32 (:class:`_Bf16Product`), ``silu(g) * u`` rounded to bf16,
    and the down product summed in float32.  XLA keeps the cotangent of
    a bf16 x bf16 -> float32 product in float32 where the port's backward
    rounds it to bf16 first (one bf16 rounding more)."""
    if not flags().bf16_experts:
        _no_tf32()
        xf = x.float()
        h = F.silu(torch.bmm(xf, w_gate.float())) \
            * torch.bmm(xf, w_up.float())
        return torch.bmm(h, w_down.float())
    dt = torch.bfloat16
    xe = x.to(dt)
    g = _Bf16Product.apply(xe, w_gate.to(dt))
    u = _Bf16Product.apply(xe, w_up.to(dt))
    h = (F.silu(g) * u).to(dt)
    return _Bf16Product.apply(h, w_down.to(dt))


def expert_pad(n_experts: int, n_model: int) -> int:
    """E_pad: the next multiple of the ``model`` axis."""
    return -(-n_experts // n_model) * n_model


class Exchange:
    """The collectives of :func:`a2a_body` on one device's block: the
    expert weights' all-gather over ``gather`` (the non-``model`` axes
    their width is sharded over, innermost first so that the blocks come
    back in mesh order), the all-to-all over ``model`` both ways, and
    the mean over every mesh axis; autograd's functional collectives
    (the gather's backward is a reduce-scatter, an all-to-all's the
    all-to-all back).  ``Exchange()`` is one device (no collective):
    the body's local arithmetic alone.  ``slice_experts``: the weights
    hold every real expert (replicated over ``model``); each device
    pads them to E_pad and takes its own."""

    def __init__(self, mesh=None, gather=(), slice_experts=False):
        self.mesh, self.slice_experts = mesh, slice_experts
        self.gather_groups = [mesh.get_group(a) for a in reversed(gather)] \
            if mesh is not None else []
        names = mesh.mesh_dim_names if mesh is not None else ()
        self.model = mesh.get_group("model") if "model" in names else None
        self.n_model = mesh.size(names.index("model")) \
            if "model" in names else 1
        self.rank = mesh.get_local_rank("model") if "model" in names else 0
        self.all_groups = [mesh.get_group(a) for a in names]
        self.n_dev = mesh.size() if mesh is not None else 1

    def weights(self, w, dim: int, e_pad: int):
        """An expert weight's block whole in its width, this device's
        experts of the E_pad."""
        from torch.distributed import _functional_collectives as fc
        gather = getattr(fc, "all_gather_single_autograd",
                         fc.all_gather_tensor_autograd)
        for g in self.gather_groups:
            w = gather(w, dim, g)
        if self.slice_experts or self.n_model == 1:
            w = F.pad(w, (0, 0, 0, 0, 0, e_pad - w.shape[0]))
            per = e_pad // self.n_model
            w = w[self.rank * per:(self.rank + 1) * per]
        return w

    def to_experts(self, bins):
        """(E_pad, C, M) send bins -> (E_pad / model, model C, M): each
        expert's rows from every model rank, in rank order (the
        reference's ``all_to_all(split_axis=0, concat_axis=1)``)."""
        if self.model is None or self.n_model == 1:
            return bins
        from torch.distributed import _functional_collectives as fc
        e, c, m = bins.shape
        recv = fc.all_to_all_single_autograd(bins.contiguous(), None, None,
                                             self.model)
        return recv.view(self.n_model, e // self.n_model, c, m) \
            .transpose(0, 1).reshape(e // self.n_model, self.n_model * c, m)

    def from_experts(self, y):
        """The inverse of :meth:`to_experts`: (E_pad / model, model C, M)
        -> (E_pad, C, M)."""
        if self.model is None or self.n_model == 1:
            return y
        from torch.distributed import _functional_collectives as fc
        el, mc, m = y.shape
        c = mc // self.n_model
        send = y.view(el, self.n_model, c, m).transpose(0, 1).contiguous()
        back = fc.all_to_all_single_autograd(
            send.view(self.n_model * el, c, m), None, None, self.model)
        return back.view(self.n_model * el, c, m)

    def mean(self, t):
        """t averaged over every mesh axis (:class:`_MeshMean`)."""
        if self.n_dev == 1:
            return t
        return _MeshMean.apply(t, self)


class _MeshMean(torch.autograd.Function):
    """The mean of a tensor over the devices (one all-reduce sum per mesh
    axis, then / n).  Its consumers are replicated, so the gradient
    reaching each device is the same, and each device's share of the
    mean's gradient is that over n, with no collective (the reference's
    ``pmean``)."""

    @staticmethod
    def forward(ctx, t, ex):
        from torch.distributed import _functional_collectives as fc
        ctx.n = ex.n_dev
        for g in ex.all_groups:
            t = fc.all_reduce(t, "sum", g)
        return t / ex.n_dev

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def a2a_body(cfg: ArchConfig, x, router, w_gate, w_up, w_down, *,
             cap: int, e_pad: int, ex: Exchange):
    """One device's block of the expert-parallel dispatch (the
    reference's ``_a2a_body``): x (t_loc, M) its tokens, ``router`` (M,
    E), the expert weights its blocks.  The weights are gathered whole
    in their width (:meth:`Exchange.weights`); the router's top-k over
    the real experts; each kept pick scattered into its expert's bin of
    the (E_pad, C, M) send bins (:func:`slot_rule`, :func:`dispatch`);
    the bins all-to-all'd to the experts' devices, through
    :func:`expert_mlp`, and back; the picks combined (:func:`combine`).
    The balance loss E sum_e f_e p_e averages f_e and p_e over every
    mesh axis before the product.  Returns ``(out (t_loc, M), aux)``."""
    moe = cfg.moe
    wg = ex.weights(w_gate, 2, e_pad)
    wu = ex.weights(w_up, 2, e_pad)
    wd = ex.weights(w_down, 1, e_pad)
    logits = x @ router.to(x.dtype)
    probs, top_w, top_idx = router_topk(cfg, logits)
    slot, keep = slot_rule(top_idx, e_pad, cap)
    bins, index = dispatch(x, top_idx, slot, keep, e_pad, cap)
    y = expert_mlp(ex.to_experts(bins), wg, wu, wd).to(x.dtype)
    out = combine(ex.from_experts(y), index, top_w, keep)
    f_e = ex.mean(F.one_hot(top_idx[:, 0], moe.n_experts).float().mean(0))
    p_e = ex.mean(probs.mean(0))
    return out, moe.n_experts * (f_e * p_e).sum()


def _global_scatter_path(cfg: ArchConfig, p, x2d):
    """The reference's ``_global_scatter_path`` on one device's tensors:
    ``p`` holds ``router``, ``w_gate``, ``w_up`` and ``w_down``; every
    token routed into (E, C, M) bins of the capacity of all T tokens,
    overflow dropped, the experts by :func:`expert_mlp`.  Returns ``(out
    (T, M), aux)``, the aux unweighted."""
    moe = cfg.moe
    t, _ = x2d.shape
    logits = x2d @ p["router"].to(x2d.dtype)
    probs, top_w, top_idx = router_topk(cfg, logits)
    cap = capacity(t, moe)
    slot, keep = slot_rule(top_idx, moe.n_experts, cap)
    bins, index = dispatch(x2d, top_idx, slot, keep, moe.n_experts, cap)
    y = expert_mlp(bins, p["w_gate"], p["w_up"], p["w_down"]).to(x2d.dtype)
    out = combine(y, index, top_w, keep)
    return out, moe_aux_loss(probs, top_idx, moe.n_experts)


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

    def forward(self, x, with_aux: bool = True, mesh=None):
        """x (B, S, M) -> ``(y (B, S, M), aux loss x router_aux_weight)``,
        the aux None unless ``with_aux`` (serving reads none).  ``mesh``:
        training on a mesh, x and the weights DTensors (see the module's
        docstring)."""
        cfg, moe = self.cfg, self.cfg.moe
        b, s, m = x.shape
        if mesh is not None:
            y, aux = self._mesh_dispatch(x, mesh)
            return y, aux * moe.router_aux_weight
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

    # ---- on a mesh ------------------------------------------------------

    def _mesh_dispatch(self, x, mesh):
        """The reference's ``apply_moe`` dispatch on a mesh for the DTensor
        x (B, S, M), normed first: ``(y, aux)``, y a DTensor laid out as
        the routed path leaves it, aux a replicated 0-d DTensor."""
        b, s, m = x.shape
        sizes = axis_sizes(mesh)
        n_dev = int(np.prod(list(sizes.values())))
        if n_dev == 1:
            raise ValueError("a one-device mesh trains through the plain "
                             "step (mesh=None)")
        h = rms_norm(x, self.norm, self.cfg.norm_eps)
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
        nb = int(np.prod([sizes[a] for a in batch_axes])) \
            if batch_axes else 1
        if "model" in sizes and (b * s) % n_dev == 0:
            ep = sizes["model"]
            if flags().moe_3d and b % nb == 0 and s % ep == 0:
                x3 = constrain(h, mesh, (batch_axes or None, "model", None))
                y, aux = self._a2a(x3, mesh, n_dev)
            else:
                # the (B S, M) tokens over every axis, in mesh order
                bspec = batch_axes if (batch_axes and b % nb == 0) else None
                hb = constrain(h, mesh, (bspec, None, None))
                x2d = constrain(hb.reshape(b * s, m), mesh, (tuple(sizes),))
                y2d, aux = self._a2a(x2d, mesh, n_dev)
                y = constrain(y2d, mesh, (bspec, None)).reshape(b, s, m)
        else:
            y, aux = self._scatter_replicated(h, mesh)
        if self.shared is not None:
            ys = self.shared(gather_seq(h), skip_norm=True)
            y = y + ys.redistribute(mesh, y.placements).to(y.dtype)
        return y, aux

    def _expert_placements(self, mesh):
        """``(weights' placements, their gradients', gather axes,
        slice_experts)`` of the expert weights on ``mesh``."""
        from torch.distributed.tensor import Partial, Shard

        names = mesh.mesh_dim_names
        md = names.index("model")
        pl = [tuple(getattr(self, n).placements)
              for n in ("w_gate", "w_up", "w_down")]
        sliced = not pl[0][md].is_shard()
        grads = [tuple(Partial() if (i == md and sliced) else q
                       for i, q in enumerate(p)) for p in pl]
        gather = tuple(a for i, a in enumerate(names)
                       if a != "model" and any(q.is_shard() for q in
                                               (p[i] for p in pl)))
        for p, width in zip(pl, (2, 2, 1)):
            for i, q in enumerate(p):
                if q.is_shard() and q != (Shard(0) if i == md else
                                          Shard(width)):
                    raise NotImplementedError(
                        f"{self.cfg.name}: expert weights placed {p}")
        return pl, grads, gather, sliced

    def _a2a(self, x, mesh, n_dev):
        """:func:`a2a_body` on each device's block of x (a DTensor, (t, M)
        or (B, S, M)) through ``local_map``: x's gradient at its own
        placements, the router's a partial sum over every axis, the
        expert weights' at their placements (a partial sum over
        ``model`` where each device took its experts of replicated
        weights)."""
        from torch.distributed.tensor import Partial, Replicate
        from torch.distributed.tensor.experimental import local_map

        cfg, moe = self.cfg, self.cfg.moe
        pl, grads, gather, sliced = self._expert_placements(mesh)
        ex = Exchange(mesh, gather, sliced)
        e_pad = expert_pad(moe.n_experts, ex.n_model)
        t_loc = int(np.prod(x.shape[:-1])) // n_dev
        cap = capacity(t_loc, moe)
        xp = tuple(x.placements)

        def run(xl, router, wg, wu, wd):
            lead = xl.shape[:-1]
            out, aux = a2a_body(cfg, xl.reshape(-1, xl.shape[-1]), router,
                                wg, wu, wd, cap=cap, e_pad=e_pad, ex=ex)
            return out.view(*lead, -1), aux

        rep = (Replicate(),) * mesh.ndim
        fn = local_map(run, out_placements=(xp, rep),
                       in_placements=(xp, rep, *pl),
                       in_grad_placements=(xp, (Partial(),) * mesh.ndim,
                                           *grads),
                       device_mesh=mesh)
        return fn(x, self.router, self.w_gate, self.w_up, self.w_down)

    def _scatter_replicated(self, h, mesh):
        """:func:`_global_scatter_path` where the tokens do not divide
        over the devices: tokens and weights replicated, every device
        computes the whole layer (the reference leaves this layout to
        GSPMD)."""
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map

        cfg = self.cfg
        b, s, m = h.shape
        rep = (Replicate(),) * mesh.ndim
        names = ("router", "w_gate", "w_up", "w_down")
        ws = [getattr(self, n).redistribute(mesh, rep) for n in names]
        x2d = h.redistribute(mesh, rep).reshape(b * s, m)

        def run(xl, *wl):
            return _global_scatter_path(cfg, dict(zip(names, wl)), xl)

        fn = local_map(run, out_placements=(rep, rep),
                       in_placements=(rep,) * 5,
                       in_grad_placements=(rep,) * 5, device_mesh=mesh)
        out, aux = fn(x2d, *ws)
        return out.reshape(b, s, m), aux

