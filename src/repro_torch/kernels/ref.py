"""Plain PyTorch versions of the simulator-step kernels.

Same functions as the CUDA kernels of ``csrc/sim_step.cu``, written as
ordinary tensor algebra (formulas: ``repro/kernels/sim_step.py``).  The
wrappers in :mod:`repro_torch.kernels.sim_step` run these for CPU
tensors; tests and ``chip_smoke.py`` hold the CUDA kernels against them
on the card.  Nothing on the main path uses them when a card is present.
"""

from __future__ import annotations

import torch

__all__ = ["fused_step_update_ref", "fused_decision_ref", "tile_live"]

DEST_TILE = 128


def tile_live(tile_mask: torch.Tensor, width: int,
              tile: int = DEST_TILE) -> torch.Tensor:
    """(width,) bool: the column lies in a tile whose mask is nonzero."""
    return (tile_mask != 0).repeat_interleave(tile)[:width]


def fused_step_update_ref(q, split, deliver, fac, corr, inflow, tile_mask):
    """``(q_out, o_out)`` of one VC's fused forward/throttle/enqueue:
    ``q*fac - q*corr*deliver + inflow*split`` on live dest tiles, zero on
    dead ones, and ``o_out = q_out.sum(-1)``."""
    upd = q * fac[:, :, None]
    upd = upd - q * corr[:, :, None] * deliver
    upd = upd + inflow[:, None, :] * split
    live = tile_live(tile_mask, q.shape[-1])
    q_out = torch.where(live, upd, torch.zeros((), dtype=q.dtype,
                                               device=q.device))
    return q_out, q_out.sum(-1)


def fused_decision_ref(b0, split, dist, hval, cand, q_val, tile_mask,
                       thr: float):
    """Diverting candidate fluid of the per-hop UGAL rule: ``cand`` where
    ``dist * q_min > thr + hval * q_val`` with ``q_min = sum_k b0 *
    split``, zero elsewhere and on dead tiles."""
    q_min = (b0[:, :, None] * split).sum(dim=1)
    divert = dist * q_min > thr + hval * q_val[:, None]
    live = tile_live(tile_mask, split.shape[-1])
    return torch.where(divert & live, cand,
                       torch.zeros((), dtype=cand.dtype, device=cand.device))
