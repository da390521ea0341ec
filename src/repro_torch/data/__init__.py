"""The port's data pipeline: the reference's synthetic LM batches."""

from .pipeline import DataConfig, host_shard_batch, synthetic_batch

__all__ = ["DataConfig", "host_shard_batch", "synthetic_batch"]
