"""Serving on the port: the batched greedy engine."""

from .engine import Engine, ServeConfig, greedy_sample

__all__ = ["Engine", "ServeConfig", "greedy_sample"]
