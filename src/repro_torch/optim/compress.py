"""Error-feedback int8 gradient compression.

Counterpart of ``repro/optim/compress.py``: gradients quantized to int8
in blocks of 256 with one float32 scale per block (the block's max |g| /
127, 1 for an all-zero block; codes rounded half to even and clipped to
+-127), and a persistent float32 error accumulator whose residual is fed
into the next step's gradient.  The codes equal the reference's bit for
bit.  One device here, so nothing crosses a wire: the round trip is what
the reference applies before its gradient all-reduce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ef_init", "compress", "decompress", "ef_compress_grads",
           "BLOCK"]

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
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127)
    return codes.to(torch.int8), scale, pad


def decompress(codes, scale, pad: int, shape):
    flat = (codes.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def ef_compress_grads(grads: dict, errors: dict):
    """Error feedback + the quantize round trip on every gradient:
    ``(decompressed grads in their dtypes, new error accumulators)``."""
    g_new, e_new = {}, {}
    for key, g in grads.items():
        corrected = g.float() + errors[key]
        approx = decompress(*compress(corrected), g.shape)
        g_new[key] = approx.to(g.dtype)
        e_new[key] = corrected - approx
    return g_new, e_new
