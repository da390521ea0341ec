"""Optimizers of the port: AdamW and error-feedback int8 gradient
compression, as plain functions on dicts of tensors."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    adamw_update_, cosine_schedule, global_norm)
from .compress import compress, decompress, ef_compress_grads, ef_init

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_update_", "cosine_schedule", "global_norm", "compress",
           "decompress", "ef_compress_grads", "ef_init"]
