"""The kernel layer the model calls: attention, the SSD over a sequence
and the one-token SSD update.

Counterpart of ``repro/kernels/ops.py``.  The reference picks between
its Pallas kernels and a blocked jnp path (``impl``); the port has one
route per device: on CUDA tensors ``attention`` and ``ssd`` launch the
hand-written kernels, on CPU tensors they run the kernels' plain
versions, and nothing falls from one to the other.  The reference's
``REPRO_PERF`` variants (grouped GQA, bfloat16 probabilities, another SSD
chunk) are not ported: K/V and the probabilities are float32 and the
chunk is the config's.
"""

from __future__ import annotations

import torch

from .flash_attention import FlashAttention
from .ssd_scan import ssd_scan

__all__ = ["attention", "ssd", "ssd_decode_step"]


def attention(q, k, v, *, causal: bool = True, window=None,
              q_offset: int = 0, kv_len=None, scale=None):
    """Multi-head GQA attention (see :func:`repro_torch.kernels.ref.
    attention_ref` for the semantics): the flash-attention kernel on the
    card, its plain version on the CPU, differentiable through the
    backward kernels (:class:`~repro_torch.kernels.flash_attention.
    FlashAttention`); under ``no_grad`` one forward launch.  ``kv_len``
    (padded caches) has no kernel route and raises; the model's decode
    attends its cache in plain torch instead."""
    if kv_len is not None:
        raise NotImplementedError("attention with kv_len has no kernel "
                                  "route; decode attends its cache in "
                                  "models.layers")
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window, q_offset,
                                scale)


def ssd(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int = 256,
        state=None):
    """Mamba-2 SSD over a full sequence; returns ``(y, final_state)``,
    both from the chunked-scan kernel (its plain version on the CPU)."""
    return ssd_scan(x.contiguous(), dt.float().contiguous(),
                    a_log.float().contiguous(), b_mat.contiguous(),
                    c_mat.contiguous(), d_skip.float().contiguous(),
                    chunk=chunk, state=state)


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """One-token SSD update, plain torch as in the reference.  state: (B,
    H, N, P) float32; x_t: (B, H, P); dt_t: (B, H); b_t, c_t: (B, G, N).
    Returns ``(y_t (B, H, P) in x_t's dtype, new_state)``."""
    h = state.shape[1]
    rep = h // b_t.shape[1]
    a = -torch.exp(a_log.float())
    bt = b_t.float().repeat_interleave(rep, dim=1)
    ct = c_t.float().repeat_interleave(rep, dim=1)
    dtf = dt_t.float()
    decay = torch.exp(dtf * a[None, :])
    xdt = x_t.float() * dtf[..., None]
    new_state = state * decay[..., None, None] + bt[..., :, None] \
        * xdt[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", ct, new_state) \
        + x_t.float() * d_skip.float()[None, :, None]
    return y.to(x_t.dtype), new_state
