"""The port's data pipeline: the reference's synthetic LM batches."""

from .pipeline import (DataConfig, batch_specs, host_shard_batch,
                       synthetic_batch)

__all__ = ["DataConfig", "batch_specs", "host_shard_batch",
           "synthetic_batch"]
