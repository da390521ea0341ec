"""The simulator step's two kernels: the fused forward/throttle/enqueue
update of one virtual channel and the per-hop UGAL decision.

Counterpart of ``repro/kernels/sim_step.py``, whose Pallas kernels they
replace (``_kernel`` and ``_decision_kernel``).  On a CUDA tensor each
wrapper launches the hand-written Hopper kernel of ``csrc/sim_step.cu``
(built at first use by :mod:`repro_torch.kernels._build`) and counts the
launch in :data:`LAUNCHES`; on a CPU tensor it runs the plain version of
:mod:`repro_torch.kernels.ref`.  There is no fallback from one to the
other: any other device raises, and so does a failed build or launch.

Both kernels are bound by HBM bytes (no matrix product, so TF32 never
enters): one VC1 update at PN(27) in float32 reads q, split and deliver
(256.7 MB each) and writes q_out (256.7 MB).
"""

from __future__ import annotations

import torch

from .ref import DEST_TILE, fused_decision_ref, fused_step_update_ref

__all__ = ["fused_step_update", "fused_decision", "DEST_TILE", "LAUNCHES",
           "reset_launches", "n_tiles"]

# kernel launches on the card since the last reset_launches()
LAUNCHES = {"fused_step_update": 0, "fused_decision": 0}

_FLOATS = (torch.float32, torch.float64)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def n_tiles(width: int) -> int:
    return -(-width // DEST_TILE)


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> str:
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"no simulator-step kernel for device {device}")


def fused_step_update(q, split, deliver, fac, corr, inflow, tile_mask):
    """One VC's fused forward/throttle/enqueue update.

    Args:
      q:         (N, K, W) queue tensor, float32 or float64.
      split:     (N, K, W) equal-split minimal table.
      deliver:   (N, K, W) delivery mask (head == dest), q's dtype.
      fac:       (N, K)    ``1 - share * damp`` retention factor.
      corr:      (N, K)    ``share * (1 - damp)`` delivery correction.
      inflow:    (N, W)    decided VC inflow to enqueue.
      tile_mask: (ceil(W / DEST_TILE),) int32, nonzero = populated tile.

    Returns ``(q_out, o_out)``: the updated queues (zero on dead tiles)
    and the per-slot post-step occupancy ``q_out.sum(-1)``.
    """
    if q.dim() != 3:
        raise ValueError(f"q must be (N, K, W), got shape {tuple(q.shape)}")
    n, k, w = q.shape
    dt, dev = q.dtype, q.device
    if dt not in _FLOATS:
        raise TypeError(f"q has dtype {dt}; the kernel takes float32 or "
                        f"float64")
    for name, t, shape in (("q", q, (n, k, w)), ("split", split, (n, k, w)),
                           ("deliver", deliver, (n, k, w)),
                           ("fac", fac, (n, k)), ("corr", corr, (n, k)),
                           ("inflow", inflow, (n, w))):
        _check(name, t, shape, dt, dev)
    _check("tile_mask", tile_mask, (n_tiles(w),), torch.int32, dev)
    if _route(dev) == "cpu":
        return fused_step_update_ref(q, split, deliver, fac, corr, inflow,
                                     tile_mask)
    from ._build import extension
    ext = extension()
    q_out = torch.empty_like(q)
    partial = torch.empty((n * k, n_tiles(w)), dtype=dt, device=dev)
    o_out = torch.empty((n, k), dtype=dt, device=dev)
    ext.fused_step_update(q, split, deliver, fac, corr, inflow, tile_mask,
                          q_out, partial, o_out)
    LAUNCHES["fused_step_update"] += 1
    return q_out, o_out


def fused_decision(b0, split, dist, hval, cand, q_val, tile_mask,
                   thr: float):
    """The per-hop UGAL decision: diverting candidate fluid.

    Args:
      b0:        (N, K)    vc0 backlog per out-slot.
      split:     (N, K, C) equal-split minimal table (C may be the
                 compacted dest axis).
      dist:      (N, C)    remaining minimal hops.
      hval:      (N, C)    mean two-leg detour estimate.
      cand:      (N, C)    enqueueing vc0 candidate fluid.
      q_val:     (N,)      weighted vc1 backlog.
      tile_mask: (ceil(C / DEST_TILE),) int32, nonzero = candidates there.
      thr:       the threshold T in flit units.

    Returns the (N, C) diverting fluid ``cand * [dist*q_min > thr +
    hval*q_val]`` with ``q_min = sum_k b0 * split``; zero on dead tiles.
    """
    if split.dim() != 3:
        raise ValueError(f"split must be (N, K, C), got shape "
                         f"{tuple(split.shape)}")
    n, k, c = split.shape
    dt, dev = split.dtype, split.device
    if dt not in _FLOATS:
        raise TypeError(f"split has dtype {dt}; the kernel takes float32 "
                        f"or float64")
    for name, t, shape in (("b0", b0, (n, k)), ("split", split, (n, k, c)),
                           ("dist", dist, (n, c)), ("hval", hval, (n, c)),
                           ("cand", cand, (n, c)), ("q_val", q_val, (n,))):
        _check(name, t, shape, dt, dev)
    _check("tile_mask", tile_mask, (n_tiles(c),), torch.int32, dev)
    thr = float(thr)
    if _route(dev) == "cpu":
        return fused_decision_ref(b0, split, dist, hval, cand, q_val,
                                  tile_mask, thr)
    from ._build import extension
    ext = extension()
    out = torch.empty((n, c), dtype=dt, device=dev)
    ext.fused_decision(b0, split, dist, hval, cand, q_val, tile_mask, thr,
                       out)
    LAUNCHES["fused_decision"] += 1
    return out
