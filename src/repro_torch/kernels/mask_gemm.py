"""The mask+GEMM kernels of the batched-Brandes level recurrences: one
forward BFS level and one backward dependency level of a block of
sources, each a product with the adjacency fused with its mask epilogue.

Counterpart of ``repro/kernels/mask_gemm.py``, whose Pallas kernels they
replace (``_fwd_kernel`` behind ``frontier_step`` and ``_bwd_kernel``
behind ``backward_step``).  A comes compressed by column: a triple
``(indptr, indices, data)`` (int32, int32, the level state's dtype)
whose column v holds ``data[indptr[v]:indptr[v+1]]`` at rows
``indices[...]``, so that ``(x @ A)[s, v]`` is one walk down column v:
the same product on a sparse storage of A, general for any weighted A.
A graph adjacency is symmetric, so its CSR (see
:func:`repro_torch.core.graph.adjacency_csr`) is that triple.  On CUDA
tensors each wrapper launches the hand-written Hopper kernel of
``csrc/mask_gemm.cu`` (built at first use by
:mod:`repro_torch.kernels._build`) and counts the launch in
:data:`LAUNCHES`; on CPU tensors it runs the plain version of
:mod:`repro_torch.kernels.ref`.  There is no fallback from one to the
other: any other device raises, and so does a failed build or launch.

Both kernels are bound by HBM bytes: frontier_step reads front, dist and
sigma and writes nxt, dist' and sigma' (40 B per (s, v) cell in
float64), backward_step reads coeff, dist, sigma and delta and writes
delta' (36 B).  ``lvl`` is a runtime argument, so one build serves every
level.  The caller must pass a triple whose indices lie in [0, N).
"""

from __future__ import annotations

import torch

from .ref import backward_step_ref, frontier_step_ref

__all__ = ["frontier_step", "backward_step", "LAUNCHES", "reset_launches"]

# kernel launches on the card since the last reset_launches()
LAUNCHES = {"frontier_step": 0, "backward_step": 0}

_FLOATS = (torch.float32, torch.float64)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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
    ext.mask_frontier(front, *adj, dist, sigma, lvl, nxt, dist_out,
                      sigma_out, any_new)
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
    ext.mask_backward(coeff, *adj, dist, sigma, delta, lvl, out)
    LAUNCHES["backward_step"] += 1
    return out
