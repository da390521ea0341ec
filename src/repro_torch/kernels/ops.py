"""The kernel layer the model calls: attention, the SSD over a sequence,
the one-token SSD update, and the RG-LRU over a sequence and one token.

Counterpart of ``repro/kernels/ops.py``.  The reference picks between
its Pallas kernels and a blocked jnp path (``impl``); the port has one
route per device: on CUDA tensors ``attention`` and ``ssd`` launch the
hand-written kernels, on CPU tensors they run the kernels' plain
versions, and nothing falls from one to the other.  Both are
differentiable through backward kernels; the reference trains the SSD by
autodiff of its jnp path, the port through backward kernels of its own
(``csrc/ssd_scan_bwd.cu``, ``csrc/ssd_scan_bwd_fma.cu``).  The
reference's ``REPRO_PERF`` variants act here as there
(:mod:`repro_torch.perf`): under ``prob_bf16`` ``attention`` runs the
kernels' variant for bf16 probabilities in P.V (the reference's jnp
route under the flag, which its prefills of any length that its 1024-row
block does not divide take), float32 operands ignoring it as there; the
SSD chunk of ``ssd_chunk`` reaches ``ssd`` through the SSD block;
``gqa_grouped`` only changes how the reference's jnp route lays out its
einsums, and the kernels index K and V by kv head already, so it changes
no bit.  The RG-LRU has no kernel in the reference either: ``rglru`` and
``rglru_decode_step`` are plain torch on both devices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import FlashAttention
from .ssd_scan import SSDScan

__all__ = ["attention", "ssd", "ssd_decode_step", "rglru",
           "rglru_decode_step"]


def attention(q, k, v, *, causal: bool = True, window=None,
              q_offset: int = 0, kv_len=None, scale=None):
    """Multi-head GQA attention (see :func:`repro_torch.kernels.ref.
    attention_ref` for the semantics): the flash-attention kernel on the
    card, its plain version on the CPU, differentiable through the
    backward kernels (:class:`~repro_torch.kernels.flash_attention.
    FlashAttention`); under ``no_grad`` one forward launch.  ``kv_len``
    (padded caches) has no kernel route and raises; the model's decode
    attends its cache in plain torch instead.  The ``prob_bf16`` perf flag
    is read by :class:`FlashAttention`.  A value head narrower than
    q's and k's (MLA) is zero-padded to their size for the kernel, and the
    output cut back to it: zero columns of V give zero columns of P.V."""
    if kv_len is not None:
        raise NotImplementedError("attention with kv_len has no kernel "
                                  "route; decode attends its cache in "
                                  "models.layers")
    d, dv = q.shape[-1], v.shape[-1]
    if dv > d:
        raise ValueError(f"value head {dv} is wider than the q/k head {d}")
    if dv < d:
        v = F.pad(v, (0, d - dv))
    out = FlashAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal, window, q_offset,
                               scale)
    return out if dv == d else out[..., :dv]


def ssd(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int = 256,
        state=None):
    """Mamba-2 SSD over a full sequence; returns ``(y, final_state)``,
    both from the chunked-scan kernel (its plain version on the CPU),
    differentiable in every operand through the backward kernel
    (:class:`~repro_torch.kernels.ssd_scan.SSDScan`); under ``no_grad``
    one forward launch."""
    return SSDScan.apply(x.contiguous(), dt.float().contiguous(),
                         a_log.float().contiguous(), b_mat.contiguous(),
                         c_mat.contiguous(), d_skip.float().contiguous(),
                         state, chunk)


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


def _rglru_gates(x, a_gate, i_gate, a_param, c: float):
    """The RG-LRU's per-step decay a and input b = sqrt(1 - a^2) x
    sigmoid(i), float32."""
    log_a = -c * F.softplus(a_param.float()) * torch.sigmoid(a_gate.float())
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), mult * x.float() * torch.sigmoid(i_gate.float())


def rglru(x, a_gate, i_gate, a_param, *, state=None, c: float = 8.0):
    """RG-LRU over a sequence, h_t = a_t h_{t-1} + b_t: x and the gates
    (B, S, D), ``a_param`` (D,), ``state`` (B, D) float32 or None (zero).
    The reference's associative scan as a doubling scan: log2(S) passes,
    each composing every step with the one 2^i before it; a given state
    enters as a virtual step 0 (a = 0, b = state).  Returns ``(h in x's
    dtype, final state (B, D) float32)``."""
    a, b = _rglru_gates(x, a_gate, i_gate, a_param[None, None, :], c)
    if state is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([state[:, None, :].float(), b], dim=1)
    length = a.shape[1]
    shift = 1
    while shift < length:
        # (a, b)[t] <- (a[t - shift] a[t], a[t] b[t - shift] + b[t])
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    if state is not None:
        b = b[:, 1:]
    return b.to(x.dtype), b[:, -1]


def rglru_decode_step(state, x_t, a_gate_t, i_gate_t, a_param, *,
                      c: float = 8.0):
    """One-token RG-LRU update: state (B, D) float32; x_t and the gates
    (B, D).  Returns ``(h in x_t's dtype, new state float32)``."""
    a, b = _rglru_gates(x_t, a_gate_t, i_gate_t, a_param[None, :], c)
    h = a * state + b
    return h.to(x_t.dtype), h
