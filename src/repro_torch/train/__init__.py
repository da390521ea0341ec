"""Training of the port: the train step (with the ``microbatch`` perf
flag's gradient accumulation), atomic checkpoints and the fault-tolerant
trainer, on one device; the mesh, ZeRO-1 and elastic re-meshing belong
to the multi-device slice."""

from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint)
from .train_step import (TrainStepConfig, init_train_state, make_train_step,
                         train_state_from_model)
from .trainer import StepStats, Trainer, TrainerConfig

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint", "TrainStepConfig", "init_train_state",
           "make_train_step", "train_state_from_model", "StepStats",
           "Trainer", "TrainerConfig"]
