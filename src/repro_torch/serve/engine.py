"""Batched serving engine of the port: per-request unpadded prefill, then
one batched greedy decode step per token over the merged caches.

Counterpart of ``repro/serve/engine.py``.  Requests are served in
batches of up to ``max_batch``: each is prefilled alone at its own length
(padding would contaminate the SSM state and unmasked attention rows),
the caches are concatenated along the batch axis, and every decode step
advances all rows at their own positions.  It runs eagerly (the
reference jits its decode step).  Tokens stay on the device until the
batch is done; the engine reads them back once per batch.  On the card
it also records, with CUDA events (no extra synchronisation), the device
time of every prefill and of every batch's decode loop in ``stats``.

With ``mesh`` (a ``DeviceMesh``, as the reference's ``Engine`` takes
one) every prefill and decode step runs on the mesh: the model's
parameters are DTensors placed by their specs
(:func:`~repro_torch.models.model.place_params`), every rank submits
the same requests, a request's tokens (and the memory of a memory
config) are the global batch that each rank cuts to its rows, the
caches are placed by :func:`~repro_torch.models.model.cache_specs`, and
the greedy choice gathers the last position's logits whole
(:func:`greedy_sample`: vocab-parallel where the vocabulary divides
``model``, whole on every device where it does not), so every rank
emits the same tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models import build

__all__ = ["ServeConfig", "Engine", "greedy_sample"]


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    temperature: float = 0.0


def greedy_sample(logits):
    """(B, S, V) logits -> (B,) int32 argmax of the last position.  Of
    DTensor logits (vocab-parallel on a mesh) the last position's (B, 1,
    V) slice is gathered whole first: the argmax is over the whole
    vocabulary, on every rank."""
    last = logits[:, -1:, :]
    if isinstance(last, DTensor):
        last = last.full_tensor()
    return torch.argmax(last[:, 0], dim=-1).to(torch.int32)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


@dataclass
class Engine:
    cfg: ArchConfig
    params: Any                     # the port's Model, on ``device``
    scfg: ServeConfig = ServeConfig()
    device: Any = None              # default: the card
    mesh: Any = None                # a DeviceMesh: serve on it

    def __post_init__(self):
        self.device = resolve_device(self.device)
        where = self.params.device
        if where.type != self.device.type:
            raise ValueError(f"the model is on {where}, the engine on "
                             f"{self.device}")
        self.bundle = build(self.cfg)
        self._next_rid = 0
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self.stats = {"prefill_ms": [], "decode_ms": [], "decode_steps": []}

    def _mark(self):
        """A recorded CUDA event on the card, None elsewhere."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32), max_new))
        return rid

    def run(self, memory=None) -> dict[int, list[int]]:
        """Serve everything in the queue; returns {rid: generated tokens}.
        ``memory`` (1, T, M), a tensor or an array: the frame or image
        embeddings that every request's prefill takes, as in the
        reference (an encoder config needs them)."""
        bundle, dev = self.bundle, self.device
        if memory is not None:
            memory = torch.as_tensor(memory, device=dev)
        results: dict[int, list[int]] = {}
        while self.queue:
            active = [self.queue.pop(0) for _ in
                      range(min(self.scfg.max_batch, len(self.queue)))]
            caches, first, marks = [], [], []
            for r in active:
                tokens = torch.as_tensor(r.prompt[None], dtype=torch.int64,
                                         device=dev)
                marks.append(self._mark())
                logits, c = bundle.prefill(self.params, tokens,
                                           memory=memory,
                                           cache_slots=self.scfg.max_len,
                                           mesh=self.mesh)
                caches.append(c)
                first.append(greedy_sample(logits))
                marks.append(self._mark())
            cache = bundle.concat_caches(caches)
            next_tok = torch.cat(first, 0)
            pos = torch.tensor([[len(r.prompt)] for r in active],
                               dtype=torch.int64, device=dev)
            emitted = [next_tok]
            steps = max(r.max_new for r in active) - 1
            marks.append(self._mark())
            for _ in range(steps):
                logits, cache = bundle.decode_step(
                    self.params, cache, next_tok[:, None].long(), pos,
                    mesh=self.mesh)
                next_tok = greedy_sample(logits)
                emitted.append(next_tok)
                pos = pos + 1
            marks.append(self._mark())
            toks = torch.stack(emitted, 1).cpu().numpy()   # one read back
            if marks[0] is not None:
                self.stats["prefill_ms"] += [
                    a.elapsed_time(b) for a, b in zip(marks[:-2:2],
                                                      marks[1:-2:2])]
                self.stats["decode_ms"].append(
                    marks[-2].elapsed_time(marks[-1]))
                self.stats["decode_steps"].append(steps)
            for i, r in enumerate(active):
                r.out = [int(t) for t in toks[i, :r.max_new]]
                r.done = True
                results[r.rid] = r.out
                self.done.append(r)
        return results
