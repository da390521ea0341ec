"""Serving launcher of the port: batched greedy generation on the
Engine with synthetic prompts, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --device cpu --requests 4 --max-new 8

Weights are random, drawn from ``--seed``: this exercises the serving
path (per-request unpadded prefill through the kernels, one batched
decode step per token).  A vision arch is served with no image
embeddings, as the reference's launcher serves it; an encoder arch
(seamless-m4t-large-v2) needs frame embeddings, which the launcher does
not make: serve it through ``Engine.run(memory=...)``.  The time is the ``obs.timed("serve.run")``
span around ``Engine.run``, which closes only after the card has
finished (``Span.sync`` on the device); the kernels are built before
it.  Under a tracing session the span is recorded.  ``REPRO_PERF``
(:mod:`repro_torch.perf`) applies, e.g. ``REPRO_PERF=prob_bf16`` (bf16
probabilities in every prefill and MLA decode) or ``ssd_chunk=128``, and
a run whose flags differ from the defaults prints them on one line
first.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import obs
from .._device import resolve_device
from ..configs import ARCHS, get_arch
from ..models import build
from ..perf import non_default
from ..serve.engine import Engine, ServeConfig

__all__ = ["main", "serve"]


def serve(arch: str, *, full: bool = False, requests: int = 8,
          max_new: int = 16, max_batch: int = 4, max_len: int = 128,
          seed: int = 0, device=None):
    """Build the model, serve ``requests`` random prompts; returns
    ``(results, seconds, device)``.  Raises ``ValueError`` for an encoder
    arch, whose stub frontend needs memory inputs."""
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    if cfg.encoder is not None:
        raise ValueError(
            f"{arch}: the stub frontend needs memory inputs (frame "
            f"embeddings), which this launcher does not make; serve it "
            f"through Engine.run(memory=...)")
    device = resolve_device(device)
    if non_default():
        print(f"[serve] REPRO_PERF flags: {non_default()}")
    params = build(cfg).init(seed, device)
    eng = Engine(cfg, params, ServeConfig(max_batch=max_batch,
                                          max_len=max_len), device=device)
    rng = np.random.default_rng(seed)
    for _ in range(requests):
        plen = int(rng.integers(4, min(24, max_len // 2)))
        eng.submit(rng.integers(0, cfg.vocab, plen).astype(np.int32),
                   max_new=max_new)
    if device.type == "cuda":
        from ..kernels._build import extension
        extension()                     # the kernels' build is set-up
        torch.cuda.synchronize()
    with obs.timed("serve.run", requests=requests) as sp:
        results = eng.run()
        sp.sync(device)
    return results, sp.seconds, device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced family)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "the plain versions on the CPU)")
    args = ap.parse_args(argv)
    results, dt, device = serve(
        args.arch, full=args.full, requests=args.requests,
        max_new=args.max_new, max_batch=args.max_batch,
        max_len=args.max_len, seed=args.seed, device=args.device)
    n_tok = sum(len(v) for v in results.values())
    for rid in sorted(results)[:4]:
        print(f"req {rid}: {results[rid]}")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"served {len(results)} requests / {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {name}")


if __name__ == "__main__":
    main()
