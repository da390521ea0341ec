"""Deterministic, resumable synthetic LM data.

A numpy copy of ``repro/data/pipeline.py`` (``DataConfig``,
``synthetic_batch``, ``host_shard_batch``) that gives the same tokens bit
for bit.  Tokens are a counter-mode hash of (seed, step, position), so
any host materializes exactly its rows of any step and the pipeline has
no state beyond the integer step: that is what makes checkpoint-resume
exact.  ``batch_specs`` gives the shapes and dtypes of a global batch
(the reference's dry-run stand-ins) as tensors on the meta device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DataConfig", "synthetic_batch", "host_shard_batch",
           "batch_specs"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    memory_tokens: int = 0     # vlm/audio stub frontend length
    d_model: int = 0


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """splitmix32-style avalanche, vectorized."""
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x &= np.uint32(0xFFFFFFFF)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x &= np.uint32(0xFFFFFFFF)
    return x ^ (x >> np.uint32(16))


def synthetic_batch(cfg: DataConfig, step: int, rows: slice | None = None):
    """Rows ``rows`` (default all) of the global batch of ``step`` as
    numpy: ``{"tokens": (b, S) int32}`` (plus ``"memory"`` float32 when
    ``memory_tokens``).  Zipf-ish marginals (a squared uniform) and every
    third token repeating its predecessor, so a model can learn."""
    rows = rows if rows is not None else slice(0, cfg.global_batch)
    r0, r1 = rows.start, rows.stop
    b = r1 - r0
    pos = np.arange(cfg.seq_len, dtype=np.uint32)[None, :]
    row = np.arange(r0, r1, dtype=np.uint32)[:, None]
    base = _hash_u32(np.uint32(cfg.seed) ^ _hash_u32(
        np.uint32(step) + np.uint32(0x9E3779B9) * row))
    raw = _hash_u32(base + pos * np.uint32(0x85EBCA6B))
    u = raw.astype(np.float64) / 2**32
    tok = np.minimum((u * u * cfg.vocab).astype(np.int32), cfg.vocab - 1)
    tok[:, 2::3] = tok[:, 1::3][:, : tok[:, 2::3].shape[1]]
    out = {"tokens": tok}
    if cfg.memory_tokens:
        mem_raw = _hash_u32(base[:, :1] + np.arange(
            cfg.memory_tokens * cfg.d_model, dtype=np.uint32)[None, :])
        mem = (mem_raw.astype(np.float32) / 2**31 - 1.0).reshape(
            b, cfg.memory_tokens, cfg.d_model)
        out["memory"] = mem.astype(np.float32)
    return out


def host_shard_batch(cfg: DataConfig, step: int, host_id: int, n_hosts: int):
    """The rows host ``host_id`` of ``n_hosts`` owns."""
    per = cfg.global_batch // n_hosts
    return synthetic_batch(cfg, step,
                           slice(host_id * per, (host_id + 1) * per))


def batch_specs(cfg: DataConfig) -> dict:
    """The global batch's shapes and dtypes, as meta tensors (nothing
    allocated): ``tokens`` (B, S) int32 and, with ``memory_tokens``,
    ``memory`` (B, T, d_model) bfloat16, as the step reads them."""
    s = {"tokens": torch.empty((cfg.global_batch, cfg.seq_len),
                               dtype=torch.int32, device="meta")}
    if cfg.memory_tokens:
        s["memory"] = torch.empty(
            (cfg.global_batch, cfg.memory_tokens, cfg.d_model),
            dtype=torch.bfloat16, device="meta")
    return s
