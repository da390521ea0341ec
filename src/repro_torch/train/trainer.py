"""Training loop with the fault-tolerance features of the reference's
``repro/train/trainer.py``, on one device:

* periodic async checkpoints and exact resume: the step, the data and
  the weights' seed are all functions of the saved integer step;
* crash replay: a ``fault_hook`` returning ``"crash"`` drops the
  in-memory state, and the loop resumes from the newest checkpoint and
  replays from there;
* straggler detection: a step longer than ``straggler_factor`` times the
  median of the last 20 (once 5 are known) is recorded.

Each step is an ``obs.timed("train.step")`` span, as in the reference:
it opens before the fault hook and closes only after the new state's
work is done on the card (``Span.sync`` on the state's tensors), so the
time covers the input batch, the whole step and any stall.  It
measures with obs off and is recorded under a tracing session.  The
step donates the old state (updates it in place), as the reference's
trainer's does; a checkpoint copies every leaf to the host before
``save_async`` returns, so the next step cannot change what is saved.

With a ``mesh`` (a ``DeviceMesh`` of more than one device; the
reference's ``Trainer(..., mesh)``) the step is the sharded one
(:func:`~repro_torch.train.train_step.make_train_step` with ``mesh``):
every rank builds or restores the whole state on the host side and
keeps its blocks (:func:`~repro_torch.train.elastic.reshard_state`); a
checkpoint gathers the state on every rank and rank 0 writes it.  The
``microbatch`` perf flag and ``grad_compress`` run there as on one
device: the error accumulators ``ef`` sit at their parameters'
placements and are checkpointed, restored and placed with the rest of
the state.  An elastic restart onto a survivor mesh is ROADMAP queue 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import obs
from .._device import resolve_device
from ..configs.base import ArchConfig
from ..data import DataConfig, synthetic_batch
from .checkpoint import CheckpointManager, latest_step, restore_checkpoint
from .elastic import reshard_state
from .train_step import (TrainStepConfig, init_train_state,
                         make_train_state_specs, make_train_step)

__all__ = ["TrainerConfig", "Trainer", "StepStats", "DEFAULT_CKPT_DIR"]

# inside the checkout, beside the kernels' build; .gitignore lists it
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "train_ckpt"


def _int(t) -> int:
    """A 0-d tensor's value (a replicated DTensor's local copy)."""
    return int(t.to_local() if hasattr(t, "to_local") else t)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = str(DEFAULT_CKPT_DIR)
    log_every: int = 10
    straggler_factor: float = 3.0
    keep_checkpoints: int = 3


@dataclass
class StepStats:
    step: int
    loss: float
    seconds: float
    straggler: bool


@dataclass
class Trainer:
    cfg: ArchConfig
    data: DataConfig
    tcfg: TrainerConfig = field(default_factory=TrainerConfig)
    scfg: TrainStepConfig = field(default_factory=TrainStepConfig)
    device: torch.device | str | None = None
    fault_hook: Callable[[int], str | None] | None = None  # test injection
    mesh: object | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh is not None and self.mesh.size() == 1:
            self.mesh = None                # one device: the plain step
        self.step_fn = make_train_step(self.cfg, self.device, self.scfg,
                                       mesh=self.mesh)
        self.ckpt = CheckpointManager(self.tcfg.checkpoint_dir,
                                      keep=self.tcfg.keep_checkpoints)
        self.history: list[StepStats] = []
        self.straggler_steps: list[int] = []
        self.restarts: int = 0

    # -- state ---------------------------------------------------------
    def fresh_state(self, seed: int = 0) -> dict:
        return self._placed(init_train_state(self.cfg, seed, self.scfg,
                                             self.device))

    def resume_or_init(self, seed: int = 0) -> dict:
        state = init_train_state(self.cfg, seed, self.scfg, self.device)
        last = latest_step(self.tcfg.checkpoint_dir)
        if last is not None:
            state, _ = restore_checkpoint(self.tcfg.checkpoint_dir, state,
                                          last)
            print(f"[trainer] resumed from step {last}")
        return self._placed(state)

    def _placed(self, state: dict) -> dict:
        """The whole state as this rank's blocks on the mesh, if any."""
        if self.mesh is None:
            return state
        return reshard_state(state, self.mesh, make_train_state_specs(
            self.cfg, self.mesh, self.scfg))

    def _join(self) -> None:
        """Wait for the checkpoint writer; on a mesh every rank waits
        for rank 0's, so that all of them read the same newest step."""
        self.ckpt.join()
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

    def _save(self, step: int, state: dict) -> None:
        if self.mesh is not None:
            import torch.distributed as dist
            from torch.distributed.tensor import DTensor

            def whole(tree):
                if isinstance(tree, dict):
                    return {k: whole(v) for k, v in tree.items()}
                return tree.full_tensor() if isinstance(tree, DTensor) \
                    else tree
            state = whole(state)            # collective: every rank
            if dist.get_rank() != 0:
                return
        self.ckpt.save_async(step, state, extra_meta={"arch": self.cfg.name})

    # -- loop ----------------------------------------------------------
    def run(self, state=None, seed: int = 0) -> dict:
        state = state if state is not None else self.resume_or_init(seed)
        step = _int(state["step"])
        durations: list[float] = []
        while step < self.tcfg.total_steps:
            # the span closes after the card has finished the new state:
            # the step runs asynchronously there
            sp = obs.timed("train.step", step=step)
            with sp:
                if self.fault_hook is not None:
                    if self.fault_hook(step) == "crash":
                        # process death: the in-memory state is lost; the
                        # restart resumes from the newest checkpoint and
                        # replays from there (the data is a function of
                        # step)
                        self._join()
                        self.restarts += 1
                        state = None    # freed before the new one is built
                        state = self.resume_or_init(seed)
                        step = _int(state["step"])
                        continue
                state, metrics = self.step_fn(state,
                                              self._device_batch(step))
                sp.sync(state)
            dt = sp.seconds
            loss = float(metrics["loss"])
            straggler = False
            if len(durations) >= 5:
                med = float(np.median(durations[-20:]))
                if dt > self.tcfg.straggler_factor * med:
                    straggler = True
                    self.straggler_steps.append(step)
            durations.append(dt)
            self.history.append(StepStats(step, loss, dt, straggler))
            if (step % self.tcfg.log_every == 0
                    or step == self.tcfg.total_steps - 1):
                print(f"[trainer] step {step:5d} loss {loss:.4f} "
                      f"{dt * 1e3:7.1f} ms"
                      f"{'  STRAGGLER' if straggler else ''}")
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self._save(step + 1, state)
            step += 1
        self._join()
        return state

    def _device_batch(self, step: int) -> dict:
        """Step ``step``'s batch on the device: the tokens and, where the
        data has ``memory_tokens``, the memory in bf16, as the reference
        casts it."""
        host = synthetic_batch(self.data, step)
        batch = {"tokens": torch.as_tensor(host["tokens"],
                                           device=self.device)}
        if "memory" in host:
            batch["memory"] = torch.as_tensor(
                host["memory"], device=self.device).to(torch.bfloat16)
        return batch
