"""Sharded, atomic, async checkpoints of a train state.

Counterpart of ``repro/train/checkpoint.py``, with its layout:
``<dir>/step_<N>/shard_<k>.npz`` plus ``MANIFEST.json``, written to a
``.tmp`` sibling, fsynced, and renamed only then, so that a crash while
writing never spoils the newest complete checkpoint; ``restore`` takes
the newest step with a manifest.  The async writer snapshots the state
to host memory, writes in a thread while training goes on, and is joined
before the next save, so a checkpoint is at most one save stale.

Leaf names are the state's flattened keys joined by "/" (``params/
blocks.0.mixer.wq``, ``opt/count``), in sorted order; the split into
shards is by leaf index.  numpy has no bfloat16: a bfloat16 leaf is
stored losslessly as its int16 bit pattern, and the manifest's
``dtypes`` names each leaf's dtype so that restore views the bits back.
Leaves may be tensors (restored to the device and dtype of the matching
leaf of ``state_like``) or numpy arrays.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step"]


def _flatten(tree, prefix: str = "") -> list:
    """``[(name, leaf)]`` of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{prefix}{key}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(names: list, leaves: list) -> dict:
    out: dict = {}
    for name, leaf in zip(names, leaves):
        *path, last = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


class _Host(NamedTuple):
    """A leaf copied to host memory: the array to store and the name of
    the leaf's dtype."""
    arr: np.ndarray
    dtype: str


def _to_host(leaf) -> _Host:
    if isinstance(leaf, _Host):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return _Host(t.view(torch.int16).numpy(), name)
        return _Host(t.numpy(), name)
    arr = np.array(leaf)
    return _Host(arr, arr.dtype.name)


def _from_host(arr: np.ndarray, dtype_name: str, like):
    t = torch.from_numpy(np.array(arr))        # a copy; keeps 0-d arrays
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if dtype_name == "bfloat16":
        t = t.float()
    return t.numpy().astype(np.asarray(like).dtype)


def _write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory: str, step: int, state, *, n_shards: int = 1,
                    extra_meta: dict | None = None) -> str:
    """Write ``state`` as checkpoint ``step``; returns its directory."""
    flat = _flatten(state)
    names = [n for n, _ in flat]
    host = [_to_host(leaf) for _, leaf in flat]
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    per = max(1, (len(names) + n_shards - 1) // n_shards)
    shard_files = []
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, len(names))
        if lo >= hi and s > 0:
            break
        payload = {f"arr_{i}": host[i].arr for i in range(lo, hi)}
        fn = f"shard_{s:04d}.npz"
        _write(os.path.join(tmp, fn), lambda f: np.savez(f, **payload))
        shard_files.append((fn, lo, hi))
    manifest = {"step": step, "names": names,
                "dtypes": [h.dtype for h in host], "shards": shard_files,
                "time": time.time(), **(extra_meta or {})}
    _write(os.path.join(tmp, "MANIFEST.json"),
           lambda f: f.write(json.dumps(manifest).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "MANIFEST.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, state_like, step: int | None = None):
    """``(state, manifest)``: checkpoint ``step`` (default the newest)
    in the structure of ``state_like``, names and shapes checked."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    flat = _flatten(state_like)
    names = [n for n, _ in flat]
    if names != manifest["names"]:
        raise ValueError("checkpoint/state structure mismatch: "
                         f"{set(names) ^ set(manifest['names'])}")
    arrays: dict[int, np.ndarray] = {}
    for fn, lo, hi in manifest["shards"]:
        with np.load(os.path.join(d, fn)) as z:
            for i in range(lo, hi):
                arrays[i] = z[f"arr_{i}"]
    leaves = []
    for i, (name, like) in enumerate(flat):
        arr = arrays[i]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        leaves.append(_from_host(arr, manifest["dtypes"][i], like))
    return _unflatten(names, leaves), manifest


@dataclass
class CheckpointManager:
    """Async writer with bounded staleness; keeps the newest ``keep``.
    A write that failed in the writer thread raises from the next
    ``join`` (and so from the next ``save_async``)."""

    directory: str
    keep: int = 3
    n_shards: int = 1
    _thread: threading.Thread | None = None
    _last_path: str | None = None
    _error: Exception | None = None

    def save_async(self, step: int, state, extra_meta: dict | None = None):
        self.join()
        # snapshot off the device before training goes on
        flat = _flatten(state)
        host_state = _unflatten([n for n, _ in flat],
                                [_to_host(leaf) for _, leaf in flat])

        def work():
            try:
                self._last_path = save_checkpoint(
                    self.directory, step, host_state,
                    n_shards=self.n_shards, extra_meta=extra_meta)
                self._gc()
            except Exception as e:      # re-raised by join()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
