"""Flash-attention forward: causal / sliding-window / GQA online-softmax
attention with the row log-sum-exp.

Counterpart of ``repro/kernels/flash_attention.py``, whose Pallas kernel
``_fwd_kernel`` (via ``flash_attention`` -> ``_fwd``) it replaces; the
backward kernels belong to the training slice.  On CUDA tensors
:func:`flash_attention` launches the hand-written Hopper kernel of
``csrc/flash_attention.cu`` (built at first use by
:mod:`repro_torch.kernels._build`) and counts the launch in
:data:`LAUNCHES`; on CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`.  Any other device
raises, and so does a failed build or launch.

Unlike the Pallas kernel, which needs Sq and Skv to be multiples of its
blocks, the kernel takes any lengths and masks the ragged edge itself, so
an unpadded prompt of any length goes through it.  q, k and v are read in
their dtype (bfloat16 or float32) and the arithmetic is float32.  The
kernel is built for head sizes 32, 64 and 128; a smaller head is
zero-padded to the next of them (the scores and the output's first D
columns do not change).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ref import flash_attention_ref

__all__ = ["flash_attention", "LAUNCHES", "reset_launches", "HEAD_DIMS"]

# kernel launches on the card since the last reset_launches()
LAUNCHES = {"flash_attention_fwd": 0}

HEAD_DIMS = (32, 64, 128)   # head sizes the kernel is built for
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


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0, scale=None):
    """``(o, lse)``: q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq %
    Hkv == 0, contiguous, one dtype.  Query row i sits at position
    ``q_offset + i``, key j at j; masks: causal (q >= k) and sliding
    window (k > q - window).  ``o`` in q's dtype (0 on a row with no live
    key), ``lse`` (B, Hq, Sq, 1) float32; scale defaults to D**-0.5."""
    route = _check(q, k, v, window, int(q_offset))
    b, hq, sq, d = q.shape
    scale = float(scale) if scale is not None else d ** -0.5
    if route == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=int(q_offset), scale=scale)
    from ._build import extension
    ext = extension()
    d_pad = next(h for h in HEAD_DIMS if h >= d)
    if d_pad != d:
        q, k, v = (F.pad(t, (0, d_pad - d)) for t in (q, k, v))
    # the kernel reads 4 elements per load: rows must start 16-byte aligned
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
    ext.flash_fwd(q, k, v, bool(causal), 0 if window is None else int(window),
                  int(q_offset), scale, o, lse)
    LAUNCHES["flash_attention_fwd"] += 1
    if d_pad != d:
        o = o[..., :d].contiguous()
    return o, lse
