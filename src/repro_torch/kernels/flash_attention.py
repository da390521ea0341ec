"""Flash attention: causal / sliding-window / GQA online-softmax
attention with the row log-sum-exp, and its recompute backward.

Counterpart of ``repro/kernels/flash_attention.py``, whose Pallas kernels
``_fwd_kernel`` (via ``_fwd``), ``_dq_kernel`` and ``_dkv_kernel`` (via
``_bwd_impl``) it replaces, and of its ``custom_vjp`` (``_flash``):
:class:`FlashAttention` is the ``torch.autograd.Function`` whose forward
is :func:`flash_attention` and whose backward is
:func:`flash_attention_bwd`.  On CUDA tensors each wrapper launches its
hand-written Hopper kernel (the forward ``csrc/flash_attention.cu``, the
backward ``csrc/flash_attention_bwd.cu``, on the tensor cores for bf16
operands; ``csrc/flash_attention_fma.cu`` and
``csrc/flash_attention_bwd_fma.cu`` on the CUDA cores for float32 ones;
built at first use by :mod:`repro_torch.kernels._build`) and counts the
launch in :data:`LAUNCHES`; on CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.ref`.  Any other device raises, and so does a
failed build or launch.

Unlike the Pallas kernel, which needs Sq and Skv to be multiples of its
blocks, the kernel takes any lengths and masks the ragged edge itself, so
an unpadded prompt of any length goes through it.  q, k and v are read in
their dtype (bfloat16 or float32) and the arithmetic is float32 (the
bf16 kernels multiply float32 p and ds on the tensor cores as three exact
bf16 terms, :func:`repro_torch.kernels.ref.bf16_split3`).  Both
routes are built for head sizes 32, 64, 128 and 256; a smaller head is
zero-padded to the next of them (the scores and the output's first D
columns do not change: a head of 192, deepseek-v3's MLA, runs at 256);
the backward pads and cuts its gradients the same way, so they come back
at the caller's D.  At D = 256 the CUDA-core kernels of float32 operands
run smaller tiles than below it (#6 32 q rows against 32-key tiles, #7
32 keys a block), so that each block's tiles fit its 227 KB of shared
memory.  A head over 256 raises ``ValueError`` on the card, and nothing
falls back to the plain version there.

``prob_bf16`` (the perf flag, :mod:`repro_torch.perf`; the forward and
the dk/dv wrappers take it as an argument, :class:`FlashAttention` reads
the flag once per forward and hands it to its backward) selects each
kernel's variant for bf16 operands as the reference's jnp route computes
under the flag: in the forward q scale is rounded to bf16 before Q K^T
and P.V is one bf16 product of p rounded to nearest; in dk/dv the dv
product takes p as one bf16 term, while ds, and so dq and dk, keep the
float32 p.  The backward recomputes p from q scale unrounded, as it
always does: at head sizes whose scale is a power of two (16, 64, 256)
that is the forward's p, elsewhere it differs by the rounding of q
scale (2^-9 of each score at most).  Float32 operands ignore the flag,
as in the reference.  The launches per call do not change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..perf import flags
from .ref import (flash_attention_dkv_ref, flash_attention_dq_ref,
                  flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_bwd", "FlashAttention", "LAUNCHES",
           "reset_launches", "HEAD_DIMS", "FMA_HEAD_MAX"]

# kernel launches on the card since the last reset_launches()
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}

HEAD_DIMS = (32, 64, 128, 256)   # head sizes the kernels are built for
FMA_HEAD_MAX = 256               # the float32 (CUDA-core) kernels' largest
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(q, k, v, window, q_offset) -> str:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor (B, H, S, D)")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} differs from q in dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, not "
                        f"{q.dtype}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} q heads are no multiple of {k.shape[1]} kv "
                         f"heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cuda" and d > HEAD_DIMS[-1]:
        raise ValueError(f"head size {d} is over {HEAD_DIMS[-1]}")
    if q.device.type in ("cpu", "cuda"):
        return q.device.type
    raise ValueError(f"no flash-attention kernel for device {q.device}")


def _pad_head(d: int) -> int:
    return next(h for h in HEAD_DIMS if h >= d)


def _aligned(*ts):
    """The kernels read 16 bytes per load: rows must start 16-byte
    aligned."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0, scale=None, prob_bf16: bool = False):
    """``(o, lse)``: q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq %
    Hkv == 0, contiguous, one dtype.  Query row i sits at position
    ``q_offset + i``, key j at j; masks: causal (q >= k) and sliding
    window (k > q - window).  ``o`` in q's dtype (0 on a row with no live
    key), ``lse`` (B, Hq, Sq, 1) float32; scale defaults to D**-0.5.
    ``prob_bf16``: the bf16 kernel's variant for the flag (module
    docstring)."""
    route = _check(q, k, v, window, int(q_offset))
    b, hq, sq, d = q.shape
    scale = float(scale) if scale is not None else d ** -0.5
    pb = bool(prob_bf16) and q.dtype == torch.bfloat16
    if route == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=int(q_offset), scale=scale,
                                   prob_bf16=pb)
    from ._build import extension
    ext = extension()
    d_pad = _pad_head(d)
    if d_pad != d:
        q, k, v = (F.pad(t, (0, d_pad - d)) for t in (q, k, v))
    q, k, v = _aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
    ext.flash_fwd(q, k, v, bool(causal), 0 if window is None else int(window),
                  int(q_offset), scale, pb, o, lse)
    LAUNCHES["flash_attention_fwd"] += 1
    if d_pad != d:
        o = o[..., :d].contiguous()
    return o, lse


def _check_bwd(q, k, v, do, lse, dsum, window, q_offset) -> str:
    route = _check(q, k, v, window, q_offset)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("do must match q in shape, dtype and device")
    if not do.is_contiguous():
        raise ValueError("do must be contiguous")
    rows = q.shape[:3] + (1,)
    for name, t in (("lse", lse), ("dsum", dsum)):
        if (t.shape != rows or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(rows)} tensor on q's device")
    if route == "cuda" and q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the backward kernels take head sizes "
                         f"{HEAD_DIMS}; flash_attention_bwd pads")
    return route


def flash_attention_dq(q, k, v, do, lse, dsum, *, causal: bool = True,
                       window=None, q_offset: int = 0, scale=None):
    """dq of the recompute backward (kernel #6 on the card): q, do (B,
    Hq, Sq, D); k, v (B, Hkv, Skv, D); lse, dsum (B, Hq, Sq, 1) float32,
    the forward's lse and ``rowsum(do * o)``.  Returns dq in q's dtype.
    On the card D must be one of :data:`HEAD_DIMS`, in either dtype."""
    route = _check_bwd(q, k, v, do, lse, dsum, window, int(q_offset))
    scale = float(scale) if scale is not None else q.shape[3] ** -0.5
    kw = dict(causal=bool(causal), window=window, q_offset=int(q_offset),
              scale=scale)
    if route == "cpu":
        return flash_attention_dq_ref(q, k, v, do, lse, dsum, **kw)
    from ._build import extension
    ext = extension()
    q, k, v, do = _aligned(q, k, v, do)
    dq = torch.empty_like(q)
    ext.flash_dq(q, k, v, do, lse, dsum, kw["causal"],
                 0 if window is None else int(window), kw["q_offset"],
                 scale, dq)
    LAUNCHES["flash_attention_dq"] += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, dsum, *, causal: bool = True,
                        window=None, q_offset: int = 0, scale=None,
                        prob_bf16: bool = False):
    """dk and dv of the recompute backward per q head (kernel #7 on the
    card): inputs as :func:`flash_attention_dq`; returns ``(dk, dv)``,
    each (B, Hq, Skv, D) float32, for the caller to sum over each kv
    group.  ``prob_bf16``: dv from p as one bf16 term (module
    docstring)."""
    route = _check_bwd(q, k, v, do, lse, dsum, window, int(q_offset))
    scale = float(scale) if scale is not None else q.shape[3] ** -0.5
    pb = bool(prob_bf16) and q.dtype == torch.bfloat16
    kw = dict(causal=bool(causal), window=window, q_offset=int(q_offset),
              scale=scale)
    if route == "cpu":
        return flash_attention_dkv_ref(q, k, v, do, lse, dsum, prob_bf16=pb,
                                       **kw)
    from ._build import extension
    ext = extension()
    q, k, v, do = _aligned(q, k, v, do)
    b, hq, _, d = q.shape
    dk = torch.empty((b, hq, k.shape[2], d), dtype=torch.float32,
                     device=q.device)
    dv = torch.empty_like(dk)
    ext.flash_dkv(q, k, v, do, lse, dsum, kw["causal"],
                  0 if window is None else int(window), kw["q_offset"],
                  scale, pb, dk, dv)
    LAUNCHES["flash_attention_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window=None, q_offset: int = 0, scale=None,
                        prob_bf16: bool = False):
    """``(dq, dk, dv)`` of :func:`flash_attention` at cotangent ``do``,
    the reference's ``_bwd_impl``: ``dsum = rowsum(do * o)`` in float32,
    then the dq and dk/dv kernels, dk and dv summed over each kv group in
    float32.  dq in q's dtype, dk and dv in k's.  ``o`` and ``lse`` are
    the forward's outputs.  p is exactly 0 on masked entries (see
    :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`).
    ``prob_bf16`` goes to the dk/dv kernel."""
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = float(scale) if scale is not None else d ** -0.5
    dsum = (do.float() * o.float()).sum(-1, keepdim=True)
    d_pad = _pad_head(d) if q.device.type == "cuda" else d
    if d_pad != d:
        q, k, v, do = (F.pad(t, (0, d_pad - d)) for t in (q, k, v, do))
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    dq = flash_attention_dq(q, k, v, do, lse, dsum, **kw)
    dkh, dvh = flash_attention_dkv(q, k, v, do, lse, dsum,
                                   prob_bf16=prob_bf16, **kw)
    dk = dkh.view(b, hkv, hq // hkv, skv, d_pad).sum(2)
    dv = dvh.view(b, hkv, hq // hkv, skv, d_pad).sum(2)
    if d_pad != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the reference's ``_flash``
    custom_vjp: the forward kernel saves ``(q, k, v, o, lse)``, the
    backward runs :func:`flash_attention_bwd`.  Under ``no_grad`` it is
    one forward launch and saves nothing.  The ``prob_bf16`` perf flag
    is read once, in the forward, and the backward takes what it read."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        pb = bool(flags().prob_bf16)
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, scale=scale,
                                 prob_bf16=pb)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale, prob_bf16=pb)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None
