"""Neural building blocks of the port: RMSNorm, rotary embeddings, GQA
attention and DeepSeek's multi-head latent attention (MLA) with their
serve caches, the dense MLP and the initialisers.

Counterpart of ``repro/models/layers.py``.  Blocks are ``nn.Module``s
whose parameters keep the reference's names, shapes and dtype
(``cfg.param_dtype``) and are trainable; serving runs under
``torch.no_grad``.  Matrices are cast to the activation dtype at use, as
there.  Attention runs training and prefill through the flash-attention
kernels (:func:`repro_torch.kernels.ops.attention`, differentiable), and
prefill writes the cache; decode attends the cache in plain torch, as
the reference does outside any kernel, and updates the cache tensors in
place.  Cross-attention (an ``Attention`` built with ``cross=True`` and
given a memory) attends the memory through the kernel in every mode,
decode included, as the reference does.

On a mesh (``mesh``, a ``DeviceMesh``; training of the GQA family,
of MLA, of the cross layers and the encoder) the weights are DTensors
placed by their specs and the activations follow them.  The mesh hooks
are the reference's: ``batch_axes_for`` (the batch over ``("pod",
"data")`` where that divides it, over ``model`` too under the
``dp_over_model`` perf flag) and ``constrain_heads`` (q, k and v sharded
over ``model`` by head where the head count divides it).  A weight sharded over the batch axes
(``fsdp``) is all-gathered over them at its use, after the cast
(:func:`cast_weight`), and its gradient comes back by reduce-scatter.
The kernels run on each device's block through ``local_map``
(:func:`local_attention`, :func:`local_mla_attention`): DTensor has no
sharding rule for them.  A cross layer's K and V come from the memory,
which is sharded over the batch axes and replicated over ``model``.
Under :func:`book_local_problems` the mesh hooks book the local problem
each kernel call is handed (the dry run's kernel products).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ArchConfig
from ..kernels import ops
from ..kernels.ref import attention_prob_bf16_ref
from ..perf import flags
from .common import axis_sizes, placements

__all__ = ["rms_norm", "rope", "rope_table", "apply_rope", "cast_weight",
           "gelu", "silu", "truncated_normal", "constant", "Attention", "MLA",
           "MLP", "KPOS_PAD", "batch_axes_for", "constrain",
           "branch_out", "constrain_heads", "gather_seq", "grad_layout",
           "relayout",
           "replicated",
           "gather_fsdp", "book_local_problems", "kv_heads_read",
           "attention_block", "local_attention", "local_embedding",
           "mla_block", "local_mla_attention"]

KPOS_PAD = 2 ** 30   # position of an empty slot of a linear cache


def rms_norm(x, w, eps: float = 1e-5):
    """x normalised over its last dim, times w.  A DTensor x gets its
    gradient at its own placements (:func:`grad_layout`)."""
    if isinstance(x, DTensor):
        x = grad_layout(x)
    xf = x.float()
    if isinstance(x, DTensor) and any(p.is_shard(x.dim() - 1)
                                      for p in x.placements):
        # x's last dim is sharded (a gated norm over model-sharded
        # channels): all-reduce the (B, S, 1) sum of squares, no more
        var = (xf * xf).sum(-1, keepdim=True)
        var = var.redistribute(var.device_mesh, [
            Replicate() if p.is_partial() else p
            for p in var.placements]) / x.shape[-1]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(d: int, theta: float, device: torch.device):
    half = d // 2
    freqs = 1.0 / (theta ** (np.arange(0, half) * 2.0 / d))
    return torch.tensor(freqs, dtype=torch.float32, device=device)


def rope_table(positions, d: int, theta: float, device):
    """``(cos, sin)`` of the rotary angles, (B or 1, 1, S, d/2) float32,
    for positions (S,) or (B, S).  One table serves every layer."""
    freqs = _rope_freqs(d, float(theta), device)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[:, None, :, None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, table):
    """x: (B, H, S, D) rotated by a :func:`rope_table`."""
    cos, sin = table
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float):
    """x: (B, H, S, D); positions: (S,) or (B, S) integer tensor."""
    return apply_rope(x, rope_table(positions, x.shape[-1], theta,
                                    x.device))


def cast_weight(module: nn.Module, name: str, dtype):
    """Parameter ``name`` of ``module`` in ``dtype``.  The reference casts
    a matrix to the activation dtype at every use.  With autograd
    recording a trainable weight, so is the cast here (gradients reach
    the float32 weight); otherwise the cast is made once and reused until
    the parameter changes (same values, one launch and one pass over the
    weights less per use).  A DTensor weight is cast and then
    all-gathered over the batch axes it is sharded over
    (:func:`gather_fsdp`)."""
    w = getattr(module, name)
    if isinstance(w, DTensor):
        return gather_fsdp(w if w.dtype == dtype else w.to(dtype))
    if w.dtype == dtype:
        return w
    if w.requires_grad and torch.is_grad_enabled():
        return w.to(dtype)
    cache = module.__dict__.setdefault("_casts", {})
    hit = cache.get(name)
    if (hit is None or hit[0] is not w or hit[1] != w._version
            or hit[2].dtype != dtype or hit[2].device != w.device):
        hit = (w, w._version, w.detach().to(dtype))
        cache[name] = hit
    return hit[2]


# ---------------------------------------------------------------------------
# Mesh hooks (DTensor)
# ---------------------------------------------------------------------------

_BATCH_AXES = ("pod", "data")


def batch_axes_for(mesh, bsz: int, model_dim_divisible: bool) -> tuple:
    """Mesh axes carrying the batch dim.  With the dp_over_model perf
    flag, blocks whose model-parallel dim does NOT divide the model axis
    spread the batch over it instead of replicating (the reference's
    rule)."""
    sizes = axis_sizes(mesh)
    batch_axes = tuple(a for a in _BATCH_AXES if a in sizes)
    nb = int(np.prod([sizes[a] for a in batch_axes])) if batch_axes else 1
    mp = sizes.get("model", 1)
    if (flags().dp_over_model and not model_dim_divisible and mp > 1
            and bsz % (nb * mp) == 0):
        return batch_axes + ("model",)
    return batch_axes if (batch_axes and bsz % nb == 0) else ()


def branch_out(x, w):
    """``x @ w``, a residual branch's last product.  On DTensors the
    product is float32 (bf16 operands multiply exactly there, and the
    sum runs in float32 as in a bf16 GEMM): a contraction sharded over
    ``model`` leaves float32 partial sums, reduced in float32 and
    rounded to bf16 once, after the reduction, as the reference's
    compiled program does."""
    if isinstance(x, DTensor):
        return x.float() @ w.float()
    return x @ w


class _GradLayout(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient to the
    forward input's placements, in float32 where it is reduced."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            dtype = grad.dtype
            grad = grad.float().redistribute(ctx.mesh, ctx.placements) \
                .to(dtype)
        return grad


def grad_layout(x):
    """DTensor x unchanged, its gradient reduced to x's placements where
    it flows back (a partial sum over ``model`` from a sharded product is
    all-reduced, or reduce-scattered where x is sequence-sharded) before
    autograd adds it to the residual's: the layout GSPMD gives the
    reference's gradients."""
    return _GradLayout.apply(x)


class _Relayout(torch.autograd.Function):
    """``x.redistribute(mesh, want)``; the backward takes the gradient
    to x's placements, except that a partial sum stays one where x was
    replicated (its reduction is the train step's, in float32)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.src = mesh, tuple(x.placements)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        back = tuple(g if (s.is_replicate() and g.is_partial()) else s
                     for s, g in zip(ctx.src, grad.placements))
        if back != tuple(grad.placements):
            grad = grad.redistribute(ctx.mesh, back)
        return grad, None, None


def relayout(w, mesh, spec):
    """A weight redistributed to ``spec`` for its use, its gradient back
    at the weight's placements but left a partial sum over the axes the
    weight is replicated on (:class:`_Relayout`): an all-gather over
    ``model`` in the forward, a reduce-scatter over ``model`` in the
    backward, and no early data-parallel reduction."""
    want = placements(spec, mesh)
    return w if tuple(w.placements) == want else \
        _Relayout.apply(w, mesh, want)


def constrain(x, mesh, spec):
    """``x`` redistributed to ``spec`` on ``mesh`` (the reference's
    ``with_sharding_constraint``)."""
    want = placements(spec, mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain_heads(x, mesh):
    """(B, H, S, D) activations sharded by head over ``model`` where H
    divides it, the batch by :func:`batch_axes_for`; replicated heads
    otherwise (the reference's ``_constrain_heads``)."""
    if mesh is None:
        return x
    sizes = axis_sizes(mesh)
    heads_ok = "model" in sizes and x.shape[1] % sizes["model"] == 0
    bspec = batch_axes_for(mesh, x.shape[0], heads_ok) or None
    hspec = "model" if (heads_ok and "model" not in (bspec or ())) else None
    return constrain(x, mesh, (bspec, hspec, None, None))


def gather_seq(h):
    """A DTensor h (B, S, M) whose sequence is sharded (sequence
    parallelism) all-gathered over the sequence, the normed input of a
    block's products (Megatron-SP: norm on the shard, gather, then
    project); anything else unchanged."""
    if not isinstance(h, DTensor) or not any(p.is_shard(1)
                                             for p in h.placements):
        return h
    return h.redistribute(h.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in h.placements])


def replicated(t, mesh):
    """A plain tensor (every device holds the same values: a rotary
    table, positions) as a replicated DTensor."""
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gather_fsdp(w):
    """DTensor ``w`` all-gathered over the batch axes (``pod``,
    ``data``) it is sharded over, its model-axis sharding kept; its
    gradient comes back by reduce-scatter (:class:`_Relayout`)."""
    mesh = w.device_mesh
    want = tuple(Replicate() if name in _BATCH_AXES and p.is_shard() else p
                 for name, p in zip(mesh.mesh_dim_names, w.placements))
    return w if want == tuple(w.placements) else \
        _Relayout.apply(w, mesh, want)


def _model_rank(mesh) -> int:
    return mesh.get_local_rank("model") if "model" in \
        mesh.mesh_dim_names else 0


def _model_dim(mesh):
    names = mesh.mesh_dim_names
    return names.index("model") if "model" in names else None


_PROBLEMS: list = []


@contextlib.contextmanager
def book_local_problems():
    """Within the block, the mesh hooks book each kernel call's local
    problem: yields ``{kernel family: {problem: calls}}``, the family
    ``"attention"`` with problems ``(B, Hq, Hkv, Sq, Skv, D, window,
    causal)`` as :func:`attention_block` hands them to the kernel,
    ``"mla"`` with ``(B, H, Sq, Skv, Dqk, Dv)`` (:func:`mla_block`) and
    ``"ssd"`` with ``(B, L, H, P, G, N, chunk)``."""
    seen: dict = {}
    _PROBLEMS.append(seen)
    try:
        yield seen
    finally:
        _PROBLEMS.remove(seen)


def _book(family: str, problem: tuple) -> None:
    for seen in _PROBLEMS:
        calls = seen.setdefault(family, {})
        calls[problem] = calls.get(problem, 0) + 1


def kv_heads_read(hq: int, hkv: int, n_model: int, model_rank: int):
    """``(lo, hi)``: the kv heads that model rank ``model_rank``'s q heads
    read where the ``hq`` q heads are split ``n_model`` ways and the
    ``hkv`` kv heads are not, under the global group map (q head h reads
    kv head h // (hq / hkv)).  Raises where the local q heads do not
    read whole kv groups, as the kernel's own map on the local heads
    needs."""
    group = hq // hkv
    hq_l = hq // n_model
    first = model_rank * hq_l
    lo, hi = first // group, (first + hq_l - 1) // group + 1
    if hq_l % (hi - lo) or any(
            (first + h) // group - lo != h // (hq_l // (hi - lo))
            for h in range(hq_l)):
        raise NotImplementedError(
            f"{hq_l} of {hq} q heads a device over {hkv} kv heads: the "
            f"local q heads do not read whole kv groups")
    return lo, hi


def attention_block(ql, kl, vl, kv=None, **opts):
    """:func:`repro_torch.kernels.ops.attention` on one device's block,
    k and v first cut to the kv heads ``kv = (lo, hi)`` where given
    (:func:`kv_heads_read`); the call's problem is booked
    (:func:`book_local_problems`)."""
    if kv is not None:
        kl, vl = kl[:, kv[0]:kv[1]], vl[:, kv[0]:kv[1]]
    _book("attention", (ql.shape[0], ql.shape[1], kl.shape[1], ql.shape[2],
                        kl.shape[2], ql.shape[3], opts.get("window"),
                        bool(opts.get("causal", True))))
    return ops.attention(ql, kl, vl, **opts)


def local_attention(q, k, v, mesh, **opts):
    """:func:`attention_block` on each device's block of DTensors q (B,
    Hq, S, D) and k, v (B, Hkv, T, D), through ``local_map``; the output
    is placed as q.  Where q is sharded by head over ``model`` and k, v
    are not (fewer kv heads than the axis), each device hands the kernel
    the kv heads its q heads read under the global group map
    (:func:`kv_heads_read`), so the kernel's own map on the local heads
    stays right; the gradients of k and v are then partial sums over
    ``model``."""
    from torch.distributed.tensor.experimental import local_map

    md = _model_dim(mesh)
    q_split = md is not None and q.placements[md] == Shard(1)
    kv_split = md is not None and k.placements[md] == Shard(1)
    kv_grad = tuple(k.placements)
    kv = None
    if q_split and not kv_split:
        kv = kv_heads_read(q.shape[1], k.shape[1], mesh.size(md),
                           _model_rank(mesh))
        kv_grad = tuple(Partial() if i == md else p
                        for i, p in enumerate(k.placements))
        # the partial dk and dv are all-reduced over model right here,
        # not left for DTensor to scatter and gather again
        k, v = grad_layout(k), grad_layout(v)

    def run(ql, kl, vl):
        return attention_block(ql, kl, vl, kv, **opts)

    fn = local_map(run, out_placements=(tuple(q.placements),),
                   in_placements=(tuple(q.placements), tuple(k.placements),
                                  tuple(v.placements)),
                   in_grad_placements=(tuple(q.placements), kv_grad,
                                       kv_grad),
                   device_mesh=mesh)
    return fn(q, k, v)


def mla_block(ql, kvl, krl, *, nope: int, scale: float):
    """MLA's attention on one device's block: K the expanded ``k_nope``
    (``kvl``'s first ``nope`` columns) beside the shared rotated key
    ``krl`` (B, 1, S, qk_rope) broadcast to every head, V the rest of
    ``kvl``, through :func:`repro_torch.kernels.ops.attention` (causal;
    q/k and v padded to the kernels' head).  The call's problem ``(B,
    H, Sq, Skv, Dqk, Dv)`` is booked (:func:`book_local_problems`) under
    ``"mla"``."""
    k_nope = kvl[..., :nope]
    k = torch.cat([k_nope, krl.expand(*k_nope.shape[:-1], -1)
                   .to(k_nope.dtype)], dim=-1)
    v = kvl[..., nope:]
    _book("mla", (ql.shape[0], ql.shape[1], ql.shape[2], k.shape[2],
                  ql.shape[3], v.shape[3]))
    return ops.attention(ql, k, v, causal=True, scale=scale)


def local_mla_attention(q, kv, k_rope, mesh, *, nope: int, scale: float):
    """:func:`mla_block` on each device's block of DTensors q (B, H, S,
    qk_nope + qk_rope), kv (B, H, S, qk_nope + v_head) and k_rope (B, 1,
    S, qk_rope), through ``local_map``; the output is placed as q.  The
    shared key's gradient is the sum over the device's heads, a partial
    sum over ``model`` where the heads are split there."""
    from torch.distributed.tensor.experimental import local_map

    md = _model_dim(mesh)
    kr_grad = tuple(Partial() if (md is not None and i == md
                                  and q.placements[md] == Shard(1)) else p
                    for i, p in enumerate(k_rope.placements))

    def run(ql, kvl, krl):
        return mla_block(ql, kvl, krl, nope=nope, scale=scale)

    fn = local_map(run, out_placements=(tuple(q.placements),),
                   in_placements=(tuple(q.placements), tuple(kv.placements),
                                  tuple(k_rope.placements)),
                   in_grad_placements=(tuple(q.placements),
                                       tuple(kv.placements), kr_grad),
                   device_mesh=mesh)
    return fn(q, kv, k_rope)


def local_embedding(tokens, embed, mesh):
    """``F.embedding(tokens, embed)`` on DTensors, the table's rows (the
    vocabulary) sharded over ``model``, through ``local_map`` as
    Megatron's vocab-parallel embedding: each device looks up the tokens
    that fall in its rows, zeros elsewhere, so the output is a partial
    sum over ``model`` (one nonzero term an entry: its sum is exact) in
    the table's dtype, and the table's gradient stays in its rows."""
    from torch.distributed.tensor.experimental import local_map

    md = _model_dim(mesh)
    tp, ep = tuple(tokens.placements), tuple(embed.placements)
    if md is None or ep[md] != Shard(0):
        return F.embedding(tokens, embed)
    rows = embed.shape[0] // mesh.size(md)
    lo = _model_rank(mesh) * rows
    batch_dims = [i for i, p in enumerate(tp) if p == Shard(0)]

    def run(tok, w):
        tok = tok.long() - lo
        live = (tok >= 0) & (tok < rows)
        out = F.embedding(torch.where(live, tok, 0), w)
        return out * live[..., None].to(out.dtype)

    out_pl = tuple(Partial() if i == md else
                   (Shard(0) if i in batch_dims else Replicate())
                   for i in range(mesh.ndim))
    grad_pl = tuple(Partial() if i in batch_dims else p
                    for i, p in enumerate(ep))
    fn = local_map(run, out_placements=(out_pl,), in_placements=(tp, ep),
                   in_grad_placements=(tp, grad_pl), device_mesh=mesh)
    return fn(tokens, embed)


def truncated_normal(shape, dtype, device, generator, scale=None,
                     fan_in_dims=(0,)):
    """A parameter tensor drawn as the reference's ``truncated_normal_init``
    (standard normal cut at +-2, times ``scale`` or 1/sqrt(fan-in));
    uninitialised when ``generator`` is None (weights loaded after)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if generator is not None:
        fan_in = int(np.prod([shape[d] for d in fan_in_dims])) or 1
        std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
        nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                              generator=generator)
        t.mul_(std)
    return nn.Parameter(t.to(dtype))


def constant(shape, value, dtype, device):
    """A parameter tensor filled with ``value`` (norm gains, biases)."""
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


def _project(h, w):
    """``einsum('bsm,mhd->bhsd', h, w)``, w in h's dtype."""
    b, s, m = h.shape
    heads, d = w.shape[1], w.shape[2]
    out = h @ w.reshape(m, heads * d)
    return out.view(b, s, heads, d).transpose(1, 2)


class Attention(nn.Module):
    """GQA attention: ``wq`` (M, Hq, D), ``wk``/``wv`` (M, Hkv, D),
    ``wo`` (Hq, D, M), pre-norm ``norm`` (M,).  With ``cross=True`` it
    also has ``gate``, a 0-d parameter initialised to zero as in the
    reference (so a fresh cross layer adds nothing), and at least one kv
    head."""

    def __init__(self, cfg: ArchConfig, *, cross: bool = False, device=None,
                 generator=None):
        super().__init__()
        m, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        if cross:
            hkv = max(1, hkv)
        dh = cfg.resolved_head_dim
        dt = cfg.param_dtype
        self.cfg = cfg
        tn = functools.partial(truncated_normal, dtype=dt, device=device,
                               generator=generator)
        self.wq = tn((m, hq, dh))
        self.wk = tn((m, hkv, dh))
        self.wv = tn((m, hkv, dh))
        self.wo = tn((hq, dh, m), fan_in_dims=(0, 1))
        self.norm = constant((m,), 1.0, dt, device)
        if cross:
            self.gate = constant((), 0.0, dt, device)

    def forward(self, x, *, positions, mode: str, cache=None, window=None,
                cache_slots=None, rope_tab=None, memory=None, mesh=None):
        """mode 'train' (positions (S,); causal, the config's window, no
        cache), 'prefill' (positions (S,); returns the cache) or 'decode'
        (S = 1, positions (B, 1); cache updated in place); ``rope_tab``
        the positions' :func:`rope_table` where the caller has it.  With
        a ``memory`` (B, T, M), the layer cross-attends it instead (see
        :meth:`_cross`).  ``mesh``: training on a mesh, x and the weights
        DTensors, ``rope_tab`` replicated DTensors (see the module's
        docstring).  Returns ``(y (B, S, M), cache)``, the cache None in
        training."""
        if memory is not None:
            return self._cross(x, mode, cache, memory, mesh)
        if mesh is not None and mode != "train":
            raise NotImplementedError(
                "a mesh shards training only; the prefill and decode cells "
                "are ROADMAP queue 1")
        cfg = self.cfg
        b, s, _ = x.shape
        hq, dh = self.wq.shape[1], self.wq.shape[2]
        h = gather_seq(rms_norm(x, self.norm, cfg.norm_eps))
        q = constrain_heads(_project(h, cast_weight(self, "wq", h.dtype)),
                            mesh)
        k = constrain_heads(_project(h, cast_weight(self, "wk", h.dtype)),
                            mesh)
        v = constrain_heads(_project(h, cast_weight(self, "wv", h.dtype)),
                            mesh)
        if rope_tab is None:
            rope_tab = rope_table(positions, dh, cfg.rope_theta, x.device)
        q = apply_rope(q, rope_tab)
        k = apply_rope(k, rope_tab)
        if mode == "train" and mesh is not None:
            out = local_attention(q, k, v, mesh, causal=True, window=window)
            new_cache = None
        elif mode == "train":
            out = ops.attention(q, k, v, causal=True, window=window)
            new_cache = None
        elif mode == "prefill":
            out = ops.attention(q, k, v, causal=True, window=window)
            new_cache = self._prefill_cache(k, v, s, window, cache_slots)
        elif mode == "decode":
            out, new_cache = self._decode(q, k, v, positions, cache, window)
        else:
            raise ValueError(f"mode {mode!r}: 'train', 'prefill' or "
                             f"'decode'")
        return self._out(out), new_cache

    def _out(self, out):
        """``einsum('bhsd,hdm->bsm', out, wo)``."""
        b, hq, s, dh = out.shape
        return branch_out(out.transpose(1, 2).reshape(b, s, hq * dh),
                          cast_weight(self, "wo", out.dtype)
                          .reshape(hq * dh, -1))

    def _cross(self, x, mode, cache, memory, mesh=None):
        """Gated cross-attention to ``memory`` (the reference's
        ``apply_attention`` with a memory): only x is normed, no rope, no
        mask.  K and V are projected from the memory as given in
        training and prefill, and in decode where the cache holds no
        ``k``; otherwise they are the cache's.  Every mode attends through
        the kernel (``causal=False``; Sq = 1 in decode).  The cache is
        ``{"k", "v"}`` at the memory's length; y is scaled by
        tanh(gate).  ``mesh``: training on a mesh, x (sequence-sharded
        under sequence parallelism: gathered after the norm) and the
        memory DTensors over the batch axes; q, k and v constrained by
        head (:func:`constrain_heads`), the kernel on each device's block
        (:func:`local_attention`, Sq against the memory's Skv), ``wo``'s
        float32 partial sums over ``model`` reduced to x's layout (an
        all-reduce, or a reduce-scatter under sequence parallelism) and
        rounded before the gate scales them."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {mode!r}: 'train', 'prefill' or "
                             f"'decode'")
        if mesh is not None and mode != "train":
            raise NotImplementedError(
                "a mesh shards training only; the prefill and decode cells "
                "are ROADMAP queue 1")
        h = gather_seq(rms_norm(x, self.norm, self.cfg.norm_eps))
        q = constrain_heads(_project(h, cast_weight(self, "wq", h.dtype)),
                            mesh)
        if mode == "decode" and cache is not None \
                and cache.get("k") is not None:
            k, v = cache["k"], cache["v"]
        else:
            hm = memory.to(h.dtype)
            k, v = (constrain_heads(_project(
                hm, cast_weight(self, name, h.dtype)), mesh).contiguous()
                for name in ("wk", "wv"))
        if mesh is None:
            y = self._out(ops.attention(q, k, v, causal=False))
        else:
            # the partial sums reduced to x's layout and rounded to its
            # dtype before the gate, as the reference's program rounds
            # the product before it scales it
            y = self._out(local_attention(q, k, v, mesh, causal=False))
            y = y.redistribute(mesh, x.placements).to(x.dtype)
        return _gated(y, self.gate), \
            ({"k": k, "v": v} if mode != "train" else None)

    def encode(self, x, mesh=None):
        """Bidirectional self-attention of the encoder (the reference's
        ``_run_encoder`` body): normed x, no rope, no mask, no cache.
        ``mesh``: on a mesh, as :meth:`_cross` runs there, the kernel
        non-causal on each device's heads."""
        h = rms_norm(x, self.norm, self.cfg.norm_eps)
        q, k, v = (constrain_heads(_project(
            h, cast_weight(self, name, h.dtype)), mesh)
            for name in ("wq", "wk", "wv"))
        out = (ops.attention(q, k, v, causal=False) if mesh is None else
               local_attention(q, k, v, mesh, causal=False))
        return self._out(out)

    @staticmethod
    def _prefill_cache(k, v, s, window, cache_slots):
        b = k.shape[0]
        dev = k.device
        slots = cache_slots if cache_slots is not None else (
            min(window, s) if window is not None else s)
        if slots < s:
            # ring invariant: position p lives at slot p % slots
            shift = s % slots
            kc = torch.roll(k[:, :, -slots:], shift, dims=2)
            vc = torch.roll(v[:, :, -slots:], shift, dims=2)
            kpos = torch.roll(torch.arange(s - slots, s, device=dev), shift)
        else:
            pad = slots - s
            kc = F.pad(k, (0, 0, 0, pad))
            vc = F.pad(v, (0, 0, 0, pad))
            kpos = torch.cat([torch.arange(s, device=dev),
                              torch.full((pad,), KPOS_PAD, device=dev)])
        kpos = kpos.to(torch.int32)[None, :].repeat(b, 1)
        return {"k": kc.contiguous(), "v": vc.contiguous(), "kpos": kpos}

    @staticmethod
    def _decode(q, k, v, positions, cache, window):
        ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
        b, slots = kpos.shape
        hq, hkv, dh = q.shape[1], ck.shape[1], q.shape[3]
        pos = positions.reshape(b).to(torch.int64)
        slot = pos % slots
        rows = torch.arange(b, device=pos.device)
        ck[rows, :, slot] = k[:, :, 0]
        cv[rows, :, slot] = v[:, :, 0]
        kpos[rows, slot] = pos.to(torch.int32)
        mask_pos = kpos[:, None, None, :]
        qpos = pos[:, None, None, None]
        mask = mask_pos <= qpos
        if window is not None:
            mask &= mask_pos > qpos - window
        # q head h reads kv head h // (hq / hkv): the q heads of one group
        # stand in the rows of one product (no repeated K/V)
        qg = q.float().view(b, hkv, hq // hkv, dh)
        logits = (qg @ ck.float().transpose(-1, -2)) * dh ** -0.5
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = (probs @ cv.float()).view(b, hq, 1, dh).to(q.dtype)
        return out, {"k": ck, "v": cv, "kpos": kpos}


class _Gated(torch.autograd.Function):
    """:func:`_gated` of DTensors: the forward is y x tanh(gate) as
    DTensor computes it; the backward forms the gate's gradient on each
    device's block and leaves it a partial sum over every mesh dim on
    which y is not replicated."""

    @staticmethod
    def forward(ctx, y, gate):
        t = torch.tanh(gate)
        ctx.save_for_backward(y, t)
        return y * t.to(y.dtype)

    @staticmethod
    def backward(ctx, gy):
        y, t = ctx.saved_tensors
        want = tuple(Replicate() if p.is_partial() else p
                     for p in y.placements)
        if tuple(gy.placements) != want:
            gy = gy.redistribute(y.device_mesh, want)
        dt = (gy.to_local().float() * y.to_local().float()).sum()
        tl = t.to_local().float()
        dgate = DTensor.from_local(
            (dt * (1.0 - tl * tl)).to(t.dtype), y.device_mesh,
            [Replicate() if p.is_replicate() else Partial()
             for p in y.placements], run_check=False)
        return gy * t.to(gy.dtype), dgate


def _gated(y, gate):
    """y x tanh(gate), in y's dtype.  On DTensors (y split by batch, and
    by sequence under sequence parallelism) the replicated 0-d gate's
    gradient is left a partial sum wherever y is not replicated
    (:class:`_Gated`): its data-parallel reduction is the train step's,
    with every other gradient's, as in the reference."""
    if not isinstance(y, DTensor):
        return y * torch.tanh(gate).to(y.dtype)
    return _Gated.apply(y, gate)


class MLA(nn.Module):
    """DeepSeek's multi-head latent attention with the compressed cache:
    ``wq_a`` (M, q_lora), ``q_norm``, ``wq_b`` (q_lora, H, qk_nope +
    qk_rope), ``wkv_a`` (M, kv_lora + qk_rope), ``kv_norm``, ``wkv_b``
    (kv_lora, H, qk_nope + v_head), ``wo`` (H, v_head, M), pre-norm
    ``norm``.  A serve cache holds per position only the normed latent
    ``ckv`` (B, slots, kv_lora) and the rotated shared key ``krope`` (B,
    slots, qk_rope); every step expands K and V from it."""

    def __init__(self, cfg: ArchConfig, *, device=None, generator=None):
        super().__init__()
        mla = cfg.mla
        m, h = cfg.d_model, cfg.n_heads
        dt = cfg.param_dtype
        self.cfg = cfg
        tn = functools.partial(truncated_normal, dtype=dt, device=device,
                               generator=generator)
        self.wq_a = tn((m, mla.q_lora))
        self.q_norm = constant((mla.q_lora,), 1.0, dt, device)
        self.wq_b = tn((mla.q_lora, h, mla.qk_nope + mla.qk_rope))
        self.wkv_a = tn((m, mla.kv_lora + mla.qk_rope))
        self.kv_norm = constant((mla.kv_lora,), 1.0, dt, device)
        self.wkv_b = tn((mla.kv_lora, h, mla.qk_nope + mla.v_head))
        self.wo = tn((h, mla.v_head, m), fan_in_dims=(0, 1))
        self.norm = constant((m,), 1.0, dt, device)

    def forward(self, x, *, positions, mode: str, cache=None,
                cache_slots=None, rope_tab=None, mesh=None):
        """mode 'train', 'prefill' (the cache padded to ``cache_slots``
        where that is longer than S) or 'decode' (S = 1, positions (B, 1);
        the cache written at slot = position in place, which must be below
        the slots).  ``rope_tab``: the positions' :func:`rope_table` at
        qk_rope.  Prefill and training attend through the flash-attention
        kernel, the value head zero-padded to the q/k head; decode attends
        the cache in plain torch, masked to ``kv_len = pos + 1`` (under
        the ``prob_bf16`` perf flag with bf16 operands as the reference's
        jnp route attends then, :func:`~repro_torch.kernels.ref.
        attention_prob_bf16_ref`).  ``mesh``: training on a mesh, as the
        reference's ``apply_mla`` runs there: q and the expanded kv
        constrained by head (:func:`constrain_heads`), the kernels on
        each device's heads (:func:`local_mla_attention`), ``wo``'s
        product a partial sum over ``model`` for the block to reduce.
        Returns ``(y (B, S, M), cache)``, the cache None in training."""
        cfg, mla = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        nope, r = mla.qk_nope, mla.qk_rope
        if mesh is not None and mode != "train":
            raise NotImplementedError(
                "a mesh shards training only; the prefill and decode cells "
                "are ROADMAP queue 1")
        hidden = gather_seq(rms_norm(x, self.norm, cfg.norm_eps))
        dt = hidden.dtype
        if rope_tab is None:
            rope_tab = rope_table(positions, r, cfg.rope_theta, x.device)
        q_lat = rms_norm(hidden @ cast_weight(self, "wq_a", dt), self.q_norm,
                         cfg.norm_eps)
        q = constrain_heads(_project(q_lat, cast_weight(self, "wq_b", dt)),
                            mesh)
        q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], rope_tab)],
                      dim=-1)
        kv_a = hidden @ cast_weight(self, "wkv_a", dt)
        c_kv = rms_norm(kv_a[..., :mla.kv_lora], self.kv_norm, cfg.norm_eps)
        k_rope = apply_rope(kv_a[:, None, :, mla.kv_lora:], rope_tab)
        scale = (nope + r) ** -0.5
        if mesh is not None:
            kv = constrain_heads(_project(c_kv, cast_weight(self, "wkv_b",
                                                            dt)), mesh)
            out = local_mla_attention(q, kv, k_rope, mesh, nope=nope,
                                      scale=scale)
            new_cache = None
        elif mode == "decode":
            pos = positions.reshape(b).to(torch.int64)
            rows = torch.arange(b, device=x.device)
            ckv, krope = cache["ckv"], cache["krope"]
            ckv[rows, pos] = c_kv[:, 0]
            krope[rows, pos] = k_rope[:, 0, 0]
            new_cache = {"ckv": ckv, "krope": krope}
            k, v = self._expand(ckv, krope[:, None])
            if flags().prob_bf16 and q.dtype == torch.bfloat16:
                # the reference's jnp route with kv_len under the flag
                out = attention_prob_bf16_ref(
                    q, k, v, causal=False, kv_len=pos + 1, scale=scale)[0]
            else:
                live = torch.arange(ckv.shape[1],
                                    device=x.device)[None, :] <= pos[:, None]
                logits = (q.float() @ k.float().transpose(-1, -2)) * scale
                logits = torch.where(live[:, None, None, :], logits, -1e30)
                out = (torch.softmax(logits, dim=-1) @ v.float()).to(dt)
        elif mode in ("train", "prefill"):
            k, v = self._expand(c_kv, k_rope)
            out = ops.attention(q, k, v, causal=True, scale=scale)
            new_cache = None
            if mode == "prefill":
                pad = max(0, (cache_slots or s) - s)
                new_cache = {"ckv": F.pad(c_kv, (0, 0, 0, pad)).contiguous(),
                             "krope": F.pad(k_rope[:, 0],
                                            (0, 0, 0, pad)).contiguous()}
        else:
            raise ValueError(f"mode {mode!r}: 'train', 'prefill' or "
                             f"'decode'")
        hv = out.shape[1] * out.shape[3]
        y = branch_out(out.transpose(1, 2).reshape(b, s, hv),
                       cast_weight(self, "wo", out.dtype).reshape(hv, -1))
        return y, new_cache

    def _expand(self, c_kv, k_rope):
        """K (B, H, T, qk_nope + qk_rope) and V (B, H, T, v_head) from the
        latents (B, T, kv_lora) and the shared rotated key (B, 1, T,
        qk_rope)."""
        nope = self.cfg.mla.qk_nope
        kv = _project(c_kv, cast_weight(self, "wkv_b", c_kv.dtype))
        k_nope = kv[..., :nope]
        k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], -1)
                       .to(k_nope.dtype)], dim=-1)
        return k, kv[..., nope:]


def gelu(x):
    """The tanh GELU as the reference evaluates it (``jax.nn.gelu``,
    approximate): x/2 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), every
    step rounded to x's dtype and the constants too.  In bf16 that gives
    other bits than ``F.gelu``, which rounds once, in some 45 % of the
    entries (one bf16 step each), and the difference grows through the
    layers.  The constants are Python floats already rounded to x's
    dtype: a scalar tensor on the card would cost a copy from the host
    and a wait at every call."""
    c = _rounded(float(np.sqrt(2.0 / np.pi)), x.dtype)
    cube = x * x
    cube = cube * x
    inner = c * (x + _rounded(0.044715, x.dtype) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


class _Silu(torch.autograd.Function):
    """:func:`silu`'s steps forward, ``F.silu``'s backward (one kernel
    on x) in place of autograd through the five steps."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * torch.reciprocal(1.0 + torch.exp(-x))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.silu_backward(grad, x)


def silu(x):
    """SiLU as the reference evaluates it (``jax.nn.silu``): x (1 / (1 +
    exp(-x))), every step rounded to x's dtype.  In bf16 ``F.silu``, which
    rounds once, gives other bits in some 39 % of the entries, and over
    ten bf16-weight layers (llama-3.2-vision reduced) the logits drift
    0.04 from the reference's.  Its gradient is ``F.silu``'s."""
    return _Silu.apply(x)


_ACTS = {"silu_glu": silu, "gelu_glu": gelu, "gelu": gelu}


class MLP(nn.Module):
    """Dense MLP with pre-norm: GLU (``w_gate``, ``w_up``) or plain
    (``w_up``), then ``w_down``; of width ``d_ff`` (default the
    config's)."""

    def __init__(self, cfg: ArchConfig, *, d_ff=None, device=None,
                 generator=None):
        super().__init__()
        m, f = cfg.d_model, (d_ff if d_ff is not None else cfg.d_ff)
        dt = cfg.param_dtype
        self.cfg = cfg
        tn = functools.partial(truncated_normal, dtype=dt, device=device,
                               generator=generator)
        self.norm = constant((m,), 1.0, dt, device)
        if cfg.mlp_act.endswith("_glu"):
            self.w_gate = tn((m, f))
        self.w_up = tn((m, f))
        self.w_down = tn((f, m))

    def forward(self, x, *, skip_norm: bool = False):
        """x (B, S, M); ``skip_norm`` takes x as already normed (MoE's
        shared expert)."""
        cfg = self.cfg
        h = x if skip_norm else gather_seq(rms_norm(x, self.norm,
                                                    cfg.norm_eps))
        act = _ACTS[cfg.mlp_act]
        up = h @ cast_weight(self, "w_up", h.dtype)
        if cfg.mlp_act.endswith("_glu"):
            hidden = act(h @ cast_weight(self, "w_gate", h.dtype)) * up
        else:
            hidden = act(up)
        return branch_out(hidden, cast_weight(self, "w_down", h.dtype))
