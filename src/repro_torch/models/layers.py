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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops
from ..kernels.ref import attention_prob_bf16_ref
from ..perf import flags

__all__ = ["rms_norm", "rope", "rope_table", "apply_rope", "cast_weight",
           "gelu", "silu", "truncated_normal", "constant", "Attention", "MLA",
           "MLP", "KPOS_PAD"]

KPOS_PAD = 2 ** 30   # position of an empty slot of a linear cache


def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
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
    weights less per use)."""
    w = getattr(module, name)
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
                cache_slots=None, rope_tab=None, memory=None):
        """mode 'train' (positions (S,); causal, the config's window, no
        cache), 'prefill' (positions (S,); returns the cache) or 'decode'
        (S = 1, positions (B, 1); cache updated in place); ``rope_tab``
        the positions' :func:`rope_table` where the caller has it.  With
        a ``memory`` (B, T, M), the layer cross-attends it instead (see
        :meth:`_cross`).  Returns ``(y (B, S, M), cache)``, the cache
        None in training."""
        if memory is not None:
            return self._cross(x, mode, cache, memory)
        cfg = self.cfg
        b, s, _ = x.shape
        hq, dh = self.wq.shape[1], self.wq.shape[2]
        h = rms_norm(x, self.norm, cfg.norm_eps)
        q = _project(h, cast_weight(self, "wq", h.dtype))
        k = _project(h, cast_weight(self, "wk", h.dtype))
        v = _project(h, cast_weight(self, "wv", h.dtype))
        if rope_tab is None:
            rope_tab = rope_table(positions, dh, cfg.rope_theta, x.device)
        q = apply_rope(q, rope_tab)
        k = apply_rope(k, rope_tab)
        if mode == "train":
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
        return out.transpose(1, 2).reshape(b, s, hq * dh) \
            @ cast_weight(self, "wo", out.dtype).reshape(hq * dh, -1)

    def _cross(self, x, mode, cache, memory):
        """Gated cross-attention to ``memory`` (the reference's
        ``apply_attention`` with a memory): only x is normed, no rope, no
        mask.  K and V are projected from the memory as given in
        training and prefill, and in decode where the cache holds no
        ``k``; otherwise they are the cache's.  Every mode attends through
        the kernel (``causal=False``; Sq = 1 in decode).  The cache is
        ``{"k", "v"}`` at the memory's length; y is scaled by
        tanh(gate)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {mode!r}: 'train', 'prefill' or "
                             f"'decode'")
        h = rms_norm(x, self.norm, self.cfg.norm_eps)
        q = _project(h, cast_weight(self, "wq", h.dtype))
        if mode == "decode" and cache is not None \
                and cache.get("k") is not None:
            k, v = cache["k"], cache["v"]
        else:
            hm = memory.to(h.dtype)
            k = _project(hm, cast_weight(self, "wk", h.dtype)).contiguous()
            v = _project(hm, cast_weight(self, "wv", h.dtype)).contiguous()
        y = self._out(ops.attention(q, k, v, causal=False))
        y = y * torch.tanh(self.gate).to(y.dtype)
        return y, ({"k": k, "v": v} if mode != "train" else None)

    def encode(self, x):
        """Bidirectional self-attention of the encoder (the reference's
        ``_run_encoder`` body): normed x, no rope, no mask, no cache."""
        h = rms_norm(x, self.norm, self.cfg.norm_eps)
        q, k, v = (_project(h, cast_weight(self, name, h.dtype))
                   for name in ("wq", "wk", "wv"))
        return self._out(ops.attention(q, k, v, causal=False))

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
                cache_slots=None, rope_tab=None):
        """mode 'train', 'prefill' (the cache padded to ``cache_slots``
        where that is longer than S) or 'decode' (S = 1, positions (B, 1);
        the cache written at slot = position in place, which must be below
        the slots).  ``rope_tab``: the positions' :func:`rope_table` at
        qk_rope.  Prefill and training attend through the flash-attention
        kernel, the value head zero-padded to the q/k head; decode attends
        the cache in plain torch, masked to ``kv_len = pos + 1`` (under
        the ``prob_bf16`` perf flag with bf16 operands as the reference's
        jnp route attends then, :func:`~repro_torch.kernels.ref.
        attention_prob_bf16_ref`).  Returns
        ``(y (B, S, M), cache)``, the cache None in training."""
        cfg, mla = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        nope, r = mla.qk_nope, mla.qk_rope
        hidden = rms_norm(x, self.norm, cfg.norm_eps)
        dt = hidden.dtype
        if rope_tab is None:
            rope_tab = rope_table(positions, r, cfg.rope_theta, x.device)
        q_lat = rms_norm(hidden @ cast_weight(self, "wq_a", dt), self.q_norm,
                         cfg.norm_eps)
        q = _project(q_lat, cast_weight(self, "wq_b", dt))
        q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], rope_tab)],
                      dim=-1)
        kv_a = hidden @ cast_weight(self, "wkv_a", dt)
        c_kv = rms_norm(kv_a[..., :mla.kv_lora], self.kv_norm, cfg.norm_eps)
        k_rope = apply_rope(kv_a[:, None, :, mla.kv_lora:], rope_tab)
        scale = (nope + r) ** -0.5
        if mode == "decode":
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
        y = out.transpose(1, 2).reshape(b, s, hv) \
            @ cast_weight(self, "wo", out.dtype).reshape(hv, -1)
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
        h = x if skip_norm else rms_norm(x, self.norm, cfg.norm_eps)
        act = _ACTS[cfg.mlp_act]
        up = h @ cast_weight(self, "w_up", h.dtype)
        if cfg.mlp_act.endswith("_glu"):
            hidden = act(h @ cast_weight(self, "w_gate", h.dtype)) * up
        else:
            hidden = act(up)
        return hidden @ cast_weight(self, "w_down", h.dtype)
