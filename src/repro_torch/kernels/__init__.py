"""Hand-written Hopper kernels of the port and their plain versions."""

from .mask_gemm import backward_step, frontier_step
from .sim_step import (DEST_TILE, LAUNCHES, fused_decision,
                       fused_step_update, reset_launches)

__all__ = ["DEST_TILE", "LAUNCHES", "backward_step", "frontier_step",
           "fused_decision", "fused_step_update", "reset_launches"]
