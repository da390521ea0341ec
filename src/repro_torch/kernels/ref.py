"""Plain PyTorch versions of the port's kernels.

Same functions as the CUDA kernels of ``csrc/sim_step.cu`` and
``csrc/mask_gemm.cu``, written as ordinary tensor algebra (formulas:
``repro/kernels/sim_step.py`` and ``repro/kernels/mask_gemm.py``).  The
wrappers in :mod:`repro_torch.kernels.sim_step` and
:mod:`repro_torch.kernels.mask_gemm` run these for CPU tensors; tests and
``chip_smoke.py`` hold the CUDA kernels against them on the card.
Nothing on the main path uses them when a card is present, except the
mask epilogues, which the analytic ``dense`` engine shares.
"""

from __future__ import annotations

import torch

__all__ = ["fused_step_update_ref", "fused_decision_ref", "tile_live",
           "dense_from_csc", "frontier_epilogue", "backward_epilogue",
           "frontier_step_ref", "backward_step_ref"]

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


def dense_from_csc(indptr, indices, data) -> torch.Tensor:
    """The dense (N, N) matrix of a compressed-column triple: column v
    holds ``data[indptr[v]:indptr[v+1]]`` at rows ``indices[...]``
    (repeated entries add)."""
    n = indptr.numel() - 1
    cols = torch.repeat_interleave(
        torch.arange(n, device=data.device), (indptr[1:] - indptr[:-1]).long())
    a = torch.zeros((n, n), dtype=data.dtype, device=data.device)
    a.index_put_((indices.long(), cols), data, accumulate=True)
    return a


def frontier_epilogue(t, dist, sigma, lvl: int):
    """Mask epilogue of one forward BFS level on ``t = front @ A``:
    ``(nxt, dist', sigma', any_new)`` with ``new = (t > 0) & (dist < 0)``,
    ``nxt = t * new``, ``dist' = where(new, lvl, dist)``, ``sigma' =
    where(new, t, sigma)`` and ``any_new`` an int32 scalar tensor, 1 iff
    some vertex was claimed."""
    new = (t > 0) & (dist < 0)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    nxt = torch.where(new, t, zero)
    dist_out = torch.where(new, torch.full((), lvl, dtype=dist.dtype,
                                           device=dist.device), dist)
    return (nxt, dist_out, torch.where(new, t, sigma),
            new.any().to(torch.int32))


def backward_epilogue(t, dist, sigma, delta, lvl: int):
    """Mask epilogue of one backward dependency level on ``t = coeff @
    A``: ``delta + sigma * (t * (dist == lvl))``."""
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return delta + sigma * torch.where(dist == lvl, t, zero)


def frontier_step_ref(front, adj, dist, sigma, lvl: int):
    """Plain version of the forward mask+GEMM kernel: a dense product
    with A rebuilt from its compressed-column triple ``adj``, then
    :func:`frontier_epilogue`."""
    return frontier_epilogue(front @ dense_from_csc(*adj), dist, sigma, lvl)


def backward_step_ref(coeff, adj, dist, sigma, delta, lvl: int):
    """Plain version of the backward mask+GEMM kernel: a dense product
    with A rebuilt from its compressed-column triple ``adj``, then
    :func:`backward_epilogue`."""
    return backward_epilogue(coeff @ dense_from_csc(*adj), dist, sigma,
                             delta, lvl)
