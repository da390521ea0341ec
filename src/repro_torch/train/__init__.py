"""Training of the port: the train step (with the ``microbatch`` perf
flag's gradient accumulation and error-feedback gradient compression,
on one device and on a mesh; there also the data-parallel gradient
reduction and ZeRO-1), atomic checkpoints, the fault-tolerant trainer,
and elastic re-meshing."""

from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint)
from .elastic import largest_submesh_shape, remesh, reshard_state
from .train_step import (TrainStepConfig, batch_pspec, init_train_state,
                         make_train_state_specs, make_train_step,
                         train_state_from_model)
from .trainer import StepStats, Trainer, TrainerConfig

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint", "largest_submesh_shape", "remesh",
           "reshard_state", "TrainStepConfig", "batch_pspec",
           "init_train_state", "make_train_state_specs", "make_train_step",
           "train_state_from_model", "StepStats", "Trainer",
           "TrainerConfig"]
