"""Training launcher of the port: the entry point around
:class:`repro_torch.train.Trainer`, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --seq 2048 --batch 8 --steps 20

With no size flag it trains the published config, as the reference's
launcher does; ``--reduced`` picks the CPU-sized variant of the same
family (``--full`` names the default).  The data is the reference's
synthetic LM stream and the weights are random, drawn from ``--seed``;
a vision arch gets the pipeline's stub image embeddings, and an encoder
arch (seamless) is refused: train it through
:class:`~repro_torch.train.Trainer` with ``DataConfig(memory_tokens=seq
// frame_ratio, d_model=...)``.  Checkpoints land
in ``--ckpt-dir``; running again resumes exactly (the step, the data
and the weights' seed are functions of the saved step).  The learning
rate follows the reference launcher's cosine schedule (warmup
``min(20, steps // 10 + 1)``).  The kernels are built before the first
step.  ``REPRO_PERF`` (:mod:`repro_torch.perf`) applies, e.g.

  REPRO_PERF=prob_bf16,microbatch=2 PYTHONPATH=src \
      python -m repro_torch.launch.train --arch granite-moe-3b-a800m \
      --seq 2048 --batch 2 --steps 20

and a run whose flags differ from the defaults prints them on one line
first.  On one card ``prob_bf16``, ``ssd_chunk`` and ``microbatch``
change the computation; the mesh flags change nothing.  ``--n-layers``
cuts the depth and keeps the width: recurrentgemma-9b's 38 layers need
167 GB of train state; its first 3 (one rglru, rglru, attn group) need
44 GB, and train on one 80 GB card:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-9b --n-layers 3 --seq 4096 --batch 1 --steps 4
"""

from __future__ import annotations

import argparse

from .._device import resolve_device
from ..configs import ARCHS, get_arch
from ..data import DataConfig
from ..optim import AdamWConfig, cosine_schedule
from ..perf import non_default
from ..train.train_step import TrainStepConfig
from ..train.trainer import DEFAULT_CKPT_DIR, Trainer, TrainerConfig

__all__ = ["main", "train"]


def train(arch: str, *, reduced: bool = False, steps: int = 200,
          seq: int = 128, batch: int = 4, lr: float = 1e-3,
          ckpt_dir: str = str(DEFAULT_CKPT_DIR), ckpt_every: int = 100,
          grad_compress: bool = False, seed: int = 0, log_every: int = 10,
          device=None, fault_hook=None, n_layers=None):
    """Build the trainer and run it to ``steps``; returns ``(trainer,
    state)``.  The published config of ``arch``, or its ``reduced()``
    variant with ``reduced=True``, cut to ``n_layers`` layers where
    given.  A vision arch trains with
    ``n_image_tokens`` stub image embeddings a sequence, as the
    reference's launcher gives it.  An encoder arch raises
    ``ValueError``: its frame count is a choice of the caller's."""
    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=int(n_layers))
    if cfg.encoder is not None:
        raise ValueError(
            f"{arch}: the encoder's stub frontend needs frame embeddings, "
            f"which this launcher does not make; train it through Trainer "
            f"with DataConfig(memory_tokens=seq // "
            f"{cfg.encoder.frame_ratio}, d_model={cfg.d_model})")
    device = resolve_device(device)
    if non_default():
        print(f"[train] REPRO_PERF flags: {non_default()}")
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      memory_tokens=(cfg.vision.n_image_tokens
                                     if cfg.vision else 0),
                      d_model=cfg.d_model)
    trainer = Trainer(
        cfg, data,
        TrainerConfig(total_steps=steps, checkpoint_every=ckpt_every,
                      checkpoint_dir=ckpt_dir, log_every=log_every),
        TrainStepConfig(
            optimizer=AdamWConfig(lr=cosine_schedule(
                lr, warmup=min(20, steps // 10 + 1), total=steps)),
            grad_compress=grad_compress),
        device=device, fault_hook=fault_hook)
    if device.type == "cuda":
        from ..kernels._build import extension
        extension()                     # the kernels' build is set-up
    return trainer, trainer.run(seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", action="store_true",
                      help="the published config (the default)")
    size.add_argument("--reduced", action="store_true",
                      help="CPU-sized variant of the same family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config to this many layers (its width "
                         "unchanged)")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compress", action="store_true",
                    help="error-feedback int8 gradient compression")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "the kernels' plain versions on the CPU)")
    args = ap.parse_args(argv)
    trainer, state = train(
        args.arch, reduced=args.reduced, steps=args.steps, seq=args.seq,
        batch=args.batch, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, grad_compress=args.grad_compress,
        seed=args.seed, device=args.device, n_layers=args.n_layers)
    hist = trainer.history
    if hist:
        ms = sorted(h.seconds for h in hist)[len(hist) // 2] * 1e3
        print(f"trained {trainer.cfg.name} to step {int(state['step'])}: "
              f"loss {hist[0].loss:.4f} -> {hist[-1].loss:.4f}, median "
              f"{ms:.1f} ms per step on {trainer.device}")
    return trainer, state


if __name__ == "__main__":
    main()
