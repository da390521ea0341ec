"""Error-feedback int8 gradient compression.

Counterpart of ``repro/optim/compress.py``: gradients quantized to int8
in blocks of 256 with one float32 scale per block (the block's max |g| /
127, 1 for an all-zero block; codes rounded half to even and clipped to
+-127), and a persistent float32 error accumulator whose residual is fed
into the next step's gradient.  The codes equal the reference's bit for
bit.  The round trip is what the reference applies to its reduced
gradients, before AdamW.

On a mesh the gradients and errors are DTensors at their parameters'
placements.  A leaf whose local elements are a whole number of the
global flat order's 256-blocks, in one contiguous run
(:func:`compresses_in_place`: replicated, or evenly sharded on its
first non-unit dim with whole blocks a device), is compressed on its
local block and moves no byte; any other leaf's corrected gradient is
gathered, one mesh dim at a time from the innermost
(:func:`gather_bytes`), compressed whole and cut back to its
placements.  Either way the codes are those of the one-process
:func:`compress` of the whole gradient, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ef_init", "compress", "decompress", "ef_compress_grads",
           "compresses_in_place", "gather_bytes", "BLOCK"]

BLOCK = 256


def ef_init(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def compress(g: torch.Tensor):
    """A gradient -> ``(int8 codes (n_blocks, 256), float32 scales
    (n_blocks, 1), pad)``."""
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = F.pad(flat, (0, pad)).view(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which misses the quotient's rounding (the CPU's and
    # the reference's) by an ulp at times, and a code with it
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full(
        (), 127.0, device=flat.device)
    scale = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127)
    return codes.to(torch.int8), scale, pad


def decompress(codes, scale, pad: int, shape):
    flat = (codes.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _sharded_dims(shape, pls, mesh) -> dict:
    """``{tensor dim: number of shards}`` of placements ``pls``."""
    out: dict[int, int] = {}
    for d, p in enumerate(pls):
        if p.is_shard():
            out[p.dim] = out.get(p.dim, 1) * mesh.size(d)
        elif not p.is_replicate():
            raise ValueError(f"a gradient at {tuple(pls)}: reduce it to "
                             f"its parameter's placements first")
    return out


def compresses_in_place(shape, pls, mesh) -> bool:
    """Whether a leaf of global ``shape`` at placements ``pls`` on
    ``mesh`` holds on every device a whole number of the global flat
    order's 256-blocks in one contiguous run: replicated, or sharded
    evenly on one dim, every dim before it of size 1, a multiple of 256
    elements a device."""
    cuts = _sharded_dims(shape, pls, mesh)
    if not cuts:
        return True
    if len(cuts) > 1:
        return False
    (dim, k), = cuts.items()
    if shape[dim] % k or any(n != 1 for n in shape[:dim]):
        return False
    local = shape[dim] // k
    for n in shape[dim + 1:]:
        local *= n
    return local % BLOCK == 0


def _gathers(pls) -> list:
    """The placements after each all-gather of a leaf at ``pls`` made
    whole: one a sharded mesh dim, the innermost first."""
    from torch.distributed.tensor import Replicate

    out, cur = [], list(pls)
    for d in reversed(range(len(cur))):
        if cur[d].is_shard():
            cur[d] = Replicate()
            out.append(tuple(cur))
    return out


def gather_bytes(shape, pls, mesh) -> list:
    """The result bytes of each all-gather that :func:`ef_compress_grads`
    issues for an evenly sharded leaf that it cannot compress in place
    (float32, :func:`_gathers`' order); ``[]`` for one it compresses in
    place."""
    if compresses_in_place(shape, pls, mesh):
        return []
    out = []
    for step in _gathers(pls):
        cuts = _sharded_dims(shape, step, mesh)
        n = 4
        for dim, size in enumerate(shape):
            n *= size // cuts.get(dim, 1)
        out.append(n)
    return out


def _round_trip(corrected):
    """The codes' round trip of a float32 gradient: ``(approx, corrected
    - approx)``."""
    approx = decompress(*compress(corrected), corrected.shape)
    return approx, corrected - approx


def _on_mesh(g, e):
    """:func:`ef_compress_grads` of one DTensor leaf ``g`` with its error
    ``e`` at the same placements (see the module's docstring)."""
    from torch.distributed.tensor import DTensor

    mesh, pls = g.device_mesh, tuple(g.placements)
    if tuple(e.placements) != pls:
        raise ValueError(f"an error at {tuple(e.placements)} beside its "
                         f"gradient at {pls}")
    corrected = g.to_local().float() + e.to_local()
    if compresses_in_place(tuple(g.shape), pls, mesh):
        approx, err = _round_trip(corrected)
    else:
        whole = DTensor.from_local(corrected, mesh, pls, run_check=False,
                                   shape=g.shape, stride=g.stride())
        for step in _gathers(pls):
            whole = whole.redistribute(mesh, step)
        approx = _round_trip(whole.to_local())[0]
        approx = DTensor.from_local(approx, mesh, whole.placements,
                                    run_check=False).redistribute(
            mesh, pls).to_local()
        err = corrected - approx

    def placed(t):
        return DTensor.from_local(t, mesh, pls, run_check=False,
                                  shape=g.shape, stride=g.stride())
    return placed(approx.to(g.dtype)), placed(err)


def ef_compress_grads(grads: dict, errors: dict):
    """Error feedback + the quantize round trip on every gradient:
    ``(decompressed grads in their dtypes, new error accumulators)``.
    DTensor leaves (a mesh step's) keep their placements (see the
    module's docstring)."""
    from torch.distributed.tensor import DTensor

    g_new, e_new = {}, {}
    for key, g in grads.items():
        if isinstance(g, DTensor):
            g_new[key], e_new[key] = _on_mesh(g, errors[key])
            continue
        corrected = g.float() + errors[key]
        approx = decompress(*compress(corrected), g.shape)
        g_new[key] = approx.to(g.dtype)
        e_new[key] = corrected - approx
    return g_new, e_new
