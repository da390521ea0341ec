"""The mask+GEMM kernels of the batched-Brandes level recurrences: one
forward BFS level and one backward dependency level of a block of
sources, each a product with the adjacency fused with its mask epilogue.

Counterpart of ``repro/kernels/mask_gemm.py``, whose Pallas kernels they
replace (``_fwd_kernel`` behind ``frontier_step`` and ``_bwd_kernel``
behind ``backward_step``).  A comes compressed by column: a triple
``(indptr, indices, data)`` (int32, int32, the level state's dtype)
whose column v holds ``data[indptr[v]:indptr[v+1]]`` at rows
``indices[...]``, in any order, so that ``(x @ A)[s, v]`` is one walk
down column v: the same product on a sparse storage of A, general for
any weighted A.  A graph adjacency is symmetric, so its CSR (see
:func:`repro_torch.core.graph.adjacency_csr`, which deals each column's
entries round-robin over the shared-memory banks of their rows, the
order the kernels read fastest) is that triple.  On CUDA
tensors each wrapper launches the hand-written Hopper kernel of
``csrc/mask_gemm.cu`` (built at first use by
:mod:`repro_torch.kernels._build`) and counts the launch in
:data:`LAUNCHES`; on CPU tensors it runs the plain version of
:mod:`repro_torch.kernels.ref`.  There is no fallback from one to the
other: any other device raises, and so does a failed build or launch.

The kernels are bound by their gathers ``x[s, indices[j]]``, S * nnz(A)
of them, not by the bytes of the (S, N) operands: a block stages R rows
of ``x`` (``front`` or ``coeff``) in shared memory and reads each column
of A once for all R rows, and only the outputs whose product the
epilogue keeps are summed (see the source's header).  :func:`plan` picks
R, and the contraction chunk where R whole rows do not fit the block's
shared memory, from the card's shared memory and SM count; the kernels
sum in the order that :func:`repro_torch.kernels.ref.
masked_product_tiled` mirrors.  ``lvl`` is a runtime argument, so one
build serves every level.  The caller must pass a triple whose indices
lie in [0, N); the kernels skip an entry outside it.
"""

from __future__ import annotations

import functools

import torch

from .ref import backward_step_ref, frontier_step_ref

__all__ = ["frontier_step", "backward_step", "plan", "LAUNCHES",
           "reset_launches"]

# kernel launches on the card since the last reset_launches()
LAUNCHES = {"frontier_step": 0, "backward_step": 0}

_FLOATS = (torch.float32, torch.float64)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# rows per block that csrc/mask_gemm.cu is instantiated for, largest first
ROW_TILES = (8, 6, 4, 3, 2, 1)
# rows per block where a whole row does not fit the block's shared memory
CHUNK_ROWS = 4
# columns a warp takes at a time
GROUP = 32
# shared memory kept back from the device's per-block limit for the
# kernel's static shared memory
SMEM_RESERVE = 256


def plan(s: int, n: int, itemsize: int, smem_bytes: int,
         sms: int) -> tuple[int, int, int]:
    """Tiling of one launch on (S, N) operands of ``itemsize`` bytes, for
    a card whose blocks hold ``smem_bytes`` of shared memory and which
    has ``sms`` SMs: ``(rows, chunk, col_splits)``.

    A block stages ``rows`` rows of x, ``chunk`` entries of each at a
    time (``chunk == n``: whole rows, one pass), so ``rows * chunk *
    itemsize <= smem_bytes``; the grid holds ``ceil(s / rows) *
    col_splits`` blocks, each row group's 32-column groups cut into
    ``col_splits`` ranges where there are fewer row groups than half the
    SMs, so that a few row groups still fill the card.
    """
    if min(s, n, itemsize, smem_bytes, sms) < 1:
        raise ValueError("plan needs positive sizes")
    fit = smem_bytes // (n * itemsize)
    cap = min(fit if fit >= 1 else CHUNK_ROWS, s)
    rows = next(r for r in ROW_TILES if r <= max(cap, 1))
    if rows * n * itemsize <= smem_bytes:
        chunk = n
    else:
        chunk = smem_bytes // (rows * itemsize)
        if chunk < 1:
            raise ValueError(f"{smem_bytes} bytes of shared memory hold "
                             f"no row segment")
        if chunk >= GROUP:
            chunk -= chunk % GROUP
    groups = -(-n // GROUP)
    row_groups = -(-s // rows)
    col_splits = max(1, min(groups, sms // row_groups))
    return rows, chunk, col_splits


@functools.cache
def _card(index: int) -> tuple[int, int]:
    """(shared memory per block less the reserve, SM count) of a card."""
    from ._build import extension
    smem = int(extension().mask_smem_limit(index)) - SMEM_RESERVE
    return smem, torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(x) -> tuple[int, int, int]:
    smem, sms = _card(x.device.index if x.device.index is not None
                      else torch.cuda.current_device())
    return plan(x.shape[0], x.shape[1], x.element_size(), smem, sms)


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_level(x, adj, dist, floats: dict) -> str:
    """Validate one call's operands; return the route, cpu or cuda."""
    if x.dim() != 2:
        raise ValueError(f"the level state must be (S, N), got shape "
                         f"{tuple(x.shape)}")
    s, n = x.shape
    dt, dev = x.dtype, x.device
    if dt not in _FLOATS:
        raise TypeError(f"the level state has dtype {dt}; the kernels "
                        f"take float32 or float64")
    indptr, indices, data = adj
    _check("indptr", indptr, (n + 1,), torch.int32, dev)
    _check("indices", indices, None, torch.int32, dev)
    _check("data", data, tuple(indices.shape), dt, dev)
    if indices.dim() != 1:
        raise ValueError("indices must be one-dimensional")
    _check("dist", dist, (s, n), torch.int32, dev)
    for name, t in floats.items():
        _check(name, t, (s, n), dt, dev)
    if dev.type in ("cpu", "cuda"):
        return dev.type
    raise ValueError(f"no mask+GEMM kernel for device {dev}")


def frontier_step(front, adj, dist, sigma, lvl: int):
    """One forward BFS level, fused with its mask epilogue.

    Args:
      front: (S, N) frontier path counts, float32 or float64.
      adj:   the (N, N) A compressed by column, ``(indptr, indices,
             data)``.
      dist:  (S, N) int32 distances, -1 where not reached yet.
      sigma: (S, N) path counts so far, front's dtype.
      lvl:   the level being claimed.

    Returns ``(nxt, dist', sigma', any_new)``: with ``t = front @ A`` and
    ``new = (t > 0) & (dist < 0)``, ``nxt = where(new, t, 0)``, ``dist' =
    where(new, lvl, dist)``, ``sigma' = where(new, t, sigma)``, and
    ``any_new`` an int32 scalar tensor on the same device, 1 iff some
    vertex was claimed.
    """
    route = _check_level(front, adj, dist, {"front": front, "sigma": sigma})
    lvl = int(lvl)
    if route == "cpu":
        return frontier_step_ref(front, adj, dist, sigma, lvl)
    from ._build import extension
    ext = extension()
    nxt = torch.empty_like(front)
    dist_out = torch.empty_like(dist)
    sigma_out = torch.empty_like(sigma)
    any_new = torch.zeros((), dtype=torch.int32, device=front.device)
    if front.numel():
        ext.mask_frontier(front, *adj, dist, sigma, lvl, *_plan_for(front),
                          nxt, dist_out, sigma_out, any_new)
        LAUNCHES["frontier_step"] += 1
    return nxt, dist_out, sigma_out, any_new


def backward_step(coeff, adj, dist, sigma, delta, lvl: int):
    """One backward dependency level, fused with its mask epilogue:
    ``delta + sigma * ((coeff @ A) * (dist == lvl))`` (``lvl`` is the
    parent level, the caller's level minus one).  ``coeff``, ``sigma``
    and ``delta`` are (S, N) of one float dtype, ``dist`` (S, N) int32,
    ``adj`` A compressed by column."""
    route = _check_level(coeff, adj, dist,
                         {"coeff": coeff, "sigma": sigma, "delta": delta})
    lvl = int(lvl)
    if route == "cpu":
        return backward_step_ref(coeff, adj, dist, sigma, delta, lvl)
    from ._build import extension
    ext = extension()
    out = torch.empty_like(delta)
    if coeff.numel():
        ext.mask_backward(coeff, *adj, dist, sigma, delta, lvl,
                          *_plan_for(coeff), out)
        LAUNCHES["backward_step"] += 1
    return out
