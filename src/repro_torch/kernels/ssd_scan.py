"""The Mamba-2 SSD chunked scan: y and the final state of one sequence
pass, the float32 (N, P) state carried from chunk to chunk.

Counterpart of ``repro/kernels/ssd_scan.py``, whose Pallas kernel
``_kernel`` (via ``ssd_scan``) it replaces.  On CUDA tensors
:func:`ssd_scan` launches the hand-written Hopper kernels (built at first
use by :mod:`repro_torch.kernels._build`): for bf16 operands the
tensor-core kernels of ``csrc/ssd_scan.cu``, the chunk-parallel
decomposition of the SSD in three launches (chunk states, state passing,
chunk output; mirrored by
:func:`repro_torch.kernels.ref.ssd_scan_chunked_ref`), for float32 ones
the CUDA-core kernel of ``csrc/ssd_scan_fma.cu``.  Each call counts one
launch in :data:`LAUNCHES`.  On CPU tensors it runs the
plain version :func:`repro_torch.kernels.ref.ssd_scan_ref`.  Any other
device raises, and so does a failed build or launch.

Unlike the Pallas kernel, it also returns the final state (the reference
recomputes it on its jnp path), takes a length that is no multiple of
the chunk (the last chunk is short) and an optional initial state.  Any
chunk, d_state and head size runs on the card.  The tensor-core kernels
take d_state 64, 128, 256 or a multiple of 128 above 256 (in slices of
256 or 128 state rows) and a head size that is a multiple of 64: the
wrapper zero-pads any other d_state and head size (the padded rows and
columns of B, C, x and the state add nothing to y or to the state), and
cuts y and the state back.  The CUDA-core kernel takes a d_state that is
a multiple of 4 (the wrapper zero-pads it alike) in slices of 256 state
rows, each giving a share of y, which the wrapper adds in slice order.

The backward, :func:`ssd_scan_bwd`, has no counterpart among the Pallas
kernels: the reference trains the SSD by autodiff of its jnp path
(``_ssd_jnp_chunked``, ``repro/kernels/ops.py:145``).  On CUDA tensors it
launches hand-written kernels, counted as one launch: for bf16 operands
the tensor-core kernels of ``csrc/ssd_scan_bwd.cu``, which take the
forward's d_state and a head size of 64, 128, 192 or a multiple of 192 or
256 above (in blocks of 192 or 256 columns; the wrapper zero-pads the
operands, :func:`pad_bwd`, and cuts the gradients back, :func:`cut_bwd`),
for float32 ones the CUDA-core kernels of ``csrc/ssd_scan_bwd_fma.cu``
(any d_state and head size, no padding).  On CPU tensors it runs its
plain version :func:`repro_torch.kernels.ref.ssd_scan_bwd_ref`, and
raises elsewhere.  :class:`SSDScan` is the autograd Function over both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import _aligned
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_bwd", "SSDScan", "LAUNCHES",
           "reset_launches", "pad_fwd", "pad_bwd", "cut_bwd"]

# kernel launches on the card since the last reset_launches()
LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}

_STATE_DIMS = (64, 128, 256)   # d_state up to 256 of the tensor-core kernels
_STATE_SLICE = 128       # above 256 they take a multiple of this
_P_BLOCK = 64            # head-size multiple of the tensor-core kernels
_HEAD_BLOCKS = (256, 192)  # head blocks of the tensor-core backward over 256
_FMA_STATE = 4           # d_state multiple of the CUDA-core forward
_FMA_SLICE = 256         # state rows of its slices (a share of y each)
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(x, dt, a_log, b_mat, c_mat, d_skip, chunk, state):
    """Checks the operands of the scan and its backward; returns ``(g, n,
    chunk)`` with the chunk cut to the length."""
    if not isinstance(x, torch.Tensor) or x.dim() != 4:
        raise ValueError("x must be a 4-d tensor (B, L, H, P)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, not "
                        f"{x.dtype}")
    bsz, length, h, p = x.shape
    dev, f32 = x.device, torch.float32
    _check("x", x, x.shape, x.dtype, dev)
    if b_mat.dim() != 4:
        raise ValueError("b_mat must be (B, L, G, N)")
    g, n = b_mat.shape[2], b_mat.shape[3]
    if g == 0 or h % g:
        raise ValueError(f"{h} heads are no multiple of {g} groups")
    _check("dt", dt, (bsz, length, h), f32, dev)
    _check("a_log", a_log, (h,), f32, dev)
    _check("d_skip", d_skip, (h,), f32, dev)
    _check("b_mat", b_mat, (bsz, length, g, n), x.dtype, dev)
    _check("c_mat", c_mat, (bsz, length, g, n), x.dtype, dev)
    if state is not None:
        _check("state", state, (bsz, h, n, p), f32, dev)
    chunk = min(int(chunk), length)
    if chunk < 1:
        raise ValueError("ssd_scan needs a chunk and a length >= 1")
    return g, n, chunk


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _padded(n: int, p: int, bwd: bool = False):
    """``(d_state, head size)`` of the tensor-core kernels for ``(n, p)``:
    d_state up to 64, 128 or 256, above 256 up to a multiple of 128; the
    head size up to a multiple of 64, and in the backward above 256 up to
    the nearer multiple of 192 or 256."""
    n_pad = next((d for d in _STATE_DIMS if d >= n), _up(n, _STATE_SLICE))
    p_pad = _up(p, _P_BLOCK)
    if bwd and p_pad > _HEAD_BLOCKS[0]:
        p_pad = min(_up(p, blk) for blk in _HEAD_BLOCKS)
    return n_pad, p_pad


def _pad(n_pad, p_pad, heads=(), mats=(), states=()):
    """Zero-pads the last (head) axis of each of ``heads`` to ``p_pad``,
    the last (d_state) axis of ``mats`` to ``n_pad``, and the (N, P) axes
    of ``states`` (None stays None).  The padded rows and columns add
    nothing to y, the state or any gradient."""
    def widen(t, *widths):
        pads = [w - s for w, s in zip(widths, reversed(t.shape))]
        return F.pad(t, [a for w in pads for a in (0, w)]) if any(pads) \
            else t
    return ([widen(t, p_pad) for t in heads],
            [widen(t, n_pad) for t in mats],
            [None if t is None else widen(t, p_pad, n_pad) for t in states])


def pad_fwd(x, b_mat, c_mat, state=None):
    """The operands of :func:`ssd_scan` zero-padded to the sizes of the
    kernels for x's dtype: ``(x, b_mat, c_mat, state)``, on any device.
    bf16: d_state and head size as :func:`_padded`; float32: d_state up to
    a multiple of 4, the head size as it is."""
    n, p = b_mat.shape[3], x.shape[3]
    n_pad, p_pad = (_padded(n, p) if x.dtype == torch.bfloat16
                    else (_up(n, _FMA_STATE), p))
    (x,), (b_mat, c_mat), (state,) = _pad(n_pad, p_pad, (x,), (b_mat, c_mat),
                                          (state,))
    return x, b_mat, c_mat, state


def pad_bwd(x, b_mat, c_mat, dy, state=None, dfinal=None):
    """The operands of :func:`ssd_scan_bwd` zero-padded to the tensor-core
    kernels' sizes: ``(x, b_mat, c_mat, dy, state, dfinal)``, on any
    device (a tensor that needs no padding is returned as it is)."""
    (x, dy), (b_mat, c_mat), (state, dfinal) = _pad(
        *_padded(b_mat.shape[3], x.shape[3], bwd=True), (x, dy),
        (b_mat, c_mat), (state, dfinal))
    return x, b_mat, c_mat, dy, state, dfinal


def cut_bwd(grads, n: int, p: int):
    """:func:`ssd_scan_bwd`'s gradients of padded operands cut back to
    d_state ``n`` and head size ``p``."""
    dx, ddt, da_log, db, dc, dd, dstate = grads
    if dstate is not None:
        dstate = dstate[:, :, :n, :p].contiguous()
    return (dx[..., :p].contiguous(), ddt, da_log, db[..., :n].contiguous(),
            dc[..., :n].contiguous(), dd, dstate)


def ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int,
             state=None):
    """``(y, final_state)`` of the SSD over a sequence.

    x: (B, L, H, P) float32 or bfloat16; dt: (B, L, H) float32 positive
    step sizes; a_log, d_skip: (H,) float32; b_mat, c_mat: (B, L, G, N) in
    x's dtype, H % G == 0; state: optional (B, H, N, P) float32 initial
    state.  ``y`` in x's dtype, ``final_state`` (B, H, N, P) float32.
    The chunk is ``min(chunk, L)``: ceil(L / chunk) chunk states, any
    chunk, d_state and head size.
    """
    g, n, chunk = _check_inputs(x, dt, a_log, b_mat, c_mat, d_skip, chunk,
                                state)
    bsz, length, h, p = x.shape
    dev, f32 = x.device, torch.float32
    if dev.type == "cpu":
        return ssd_scan_ref(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk,
                            state=state)
    if dev.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for device {dev}")
    from ._build import extension
    ext = extension()
    empty = torch.empty(0, dtype=f32, device=dev)
    bf = x.dtype == torch.bfloat16
    x, b_mat, c_mat, state = pad_fwd(x, b_mat, c_mat, state)
    n_pad, p_pad = b_mat.shape[3], x.shape[3]
    cum = torch.empty((bsz, h, length), dtype=torch.float64, device=dev)
    states = empty
    if bf:
        x, b_mat, c_mat = _aligned(x, b_mat, c_mat)
        states = torch.empty((bsz, h, -(-length // chunk), n_pad, p_pad),
                             dtype=f32, device=dev)
        y = torch.empty_like(x)
    else:  # a share of y per slice of state rows
        y = torch.empty((-(-n_pad // _FMA_SLICE),) + tuple(x.shape),
                        dtype=f32, device=dev)
    final = torch.empty((bsz, h, n_pad, p_pad), dtype=f32, device=dev)
    s_in = state if state is not None else empty
    ext.ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, s_in, chunk, y, final,
                 cum, states)
    LAUNCHES["ssd_scan"] += 1
    if not bf:
        y = y[0] if y.shape[0] == 1 else y.sum(0)
    if (n_pad, p_pad) != (n, p):
        y = y[..., :p].contiguous()
        final = final[:, :, :n, :p].contiguous()
    return y, final


def ssd_scan_bwd(x, dt, a_log, b_mat, c_mat, d_skip, dy, *, chunk: int,
                 state=None, dfinal=None):
    """Gradients of :func:`ssd_scan`'s ``(y, final_state)``: ``(dx, ddt,
    da_log, db, dc, dd_skip, dstate)``, float32 in the inputs' shapes,
    ``dstate`` None without an initial state.  Operands as
    :func:`ssd_scan`; ``dy`` like x, ``dfinal`` (B, H, N, P) float32 or
    None (zero).  The chunk is ``min(chunk, L)``, as in the forward: any
    chunk, d_state and head size."""
    g, n, chunk = _check_inputs(x, dt, a_log, b_mat, c_mat, d_skip, chunk,
                                state)
    bsz, length, h, p = x.shape
    dev, f32 = x.device, torch.float32
    _check("dy", dy, x.shape, x.dtype, dev)
    if dfinal is not None:
        _check("dfinal", dfinal, (bsz, h, n, p), f32, dev)
    if dev.type == "cpu":
        return ssd_scan_bwd_ref(x, dt, a_log, b_mat, c_mat, d_skip, dy,
                                chunk=chunk, state=state, dfinal=dfinal)
    if dev.type != "cuda":
        raise ValueError(f"no ssd_scan_bwd kernel for device {dev}")
    bf = x.dtype == torch.bfloat16
    if bf:
        x, b_mat, c_mat, dy, state, dfinal = pad_bwd(x, b_mat, c_mat, dy,
                                                     state, dfinal)
        x, b_mat, c_mat, dy = _aligned(x, b_mat, c_mat, dy)
        state, dfinal = (None if t is None else _aligned(t)[0]
                         for t in (state, dfinal))
    n_k, p_k = b_mat.shape[3], x.shape[3]
    from ._build import extension
    ext = extension()
    n_chunks = -(-length // chunk)
    empty = torch.empty(0, dtype=f32, device=dev)
    dx = torch.empty((bsz, length, h, p_k), dtype=f32, device=dev)
    ddt = torch.empty((bsz, length, h), dtype=f32, device=dev)
    db_h, dc_h = (torch.empty((bsz, length, h, n_k), dtype=f32, device=dev)
                  for _ in range(2))
    dstate = (torch.empty((bsz, h, n_k, p_k), dtype=f32, device=dev)
              if state is not None else empty)
    # per (b, h, chunk) partials of d a_log and d d_skip
    parts = torch.empty((2, bsz, h, n_chunks), dtype=f32, device=dev)
    # scratch: the cumsum, each chunk's state and pull, then S_in and the
    # leaving state's gradient in their place, <S_in, dS> per chunk (the
    # tensor-core kernels: float64 partials, one per 128 state entries),
    # and per-row dcum terms (the tensor-core kernels: also the column
    # sums of M by 64-row slab)
    cum = torch.empty((bsz, h, length), dtype=torch.float64, device=dev)
    states, pulls = (torch.empty((bsz, h, n_chunks, n_k, p_k), dtype=f32,
                                 device=dev) for _ in range(2))
    sdot = (torch.empty((bsz, h, n_chunks, n_k * p_k // 128),
                        dtype=torch.float64, device=dev) if bf
            else torch.empty((bsz, h, n_chunks), dtype=f32, device=dev))
    planes = 5 + (-(-chunk // 64) if bf else 0)
    rows = torch.empty((planes, bsz, h, length), dtype=torch.float64,
                       device=dev)
    ext.ssd_scan_bwd(x, dt, a_log, b_mat, c_mat, d_skip,
                     state if state is not None else empty, dy,
                     dfinal if dfinal is not None else empty, chunk, dx, ddt,
                     db_h, dc_h, dstate, parts, cum, states, pulls, sdot,
                     rows)
    LAUNCHES["ssd_scan_bwd"] += 1
    rep = h // g
    # the fixed-axis sums: heads of a group, and (batch, chunk) partials
    db = db_h.view(bsz, length, g, rep, n_k).sum(3)
    dc = dc_h.view(bsz, length, g, rep, n_k).sum(3)
    da_log, dd = parts.sum((1, 3))
    grads = (dx, ddt, da_log, db, dc, dd,
             dstate if state is not None else None)
    return cut_bwd(grads, n, p) if (n_k, p_k) != (n, p) else grads


class SSDScan(torch.autograd.Function):
    """Differentiable :func:`ssd_scan`: the forward kernel, and
    :func:`ssd_scan_bwd` for the gradients of all its operands (the
    state's too, where one is given).  Saves the operands, not the
    forward's scratch: the backward recomputes the chunk states.  An
    unused output gives its gradient as None (zero) to the backward.
    Under ``no_grad`` it is one forward launch and saves nothing."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, d_skip, state, chunk):
        y, final = ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk,
                            state=state)
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat, d_skip, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a_log, b_mat, c_mat, d_skip, state = ctx.saved_tensors
        dy = (torch.zeros_like(x) if dy is None
              else dy.to(x.dtype).contiguous())
        if dfinal is not None:
            dfinal = dfinal.float().contiguous()
        dx, ddt, da_log, db, dc, dd, ds = ssd_scan_bwd(
            x, dt, a_log, b_mat, c_mat, d_skip, dy, chunk=ctx.chunk,
            state=state, dfinal=dfinal)
        return (dx.to(x.dtype), ddt, da_log, db.to(b_mat.dtype),
                dc.to(c_mat.dtype), dd, ds, None)
