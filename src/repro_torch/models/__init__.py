"""The model substrate of the port: GQA attention and Mamba-2 SSD
blocks, the decoder and the serving bundle."""

from .model import ModelBundle, build, unsupported
from .transformer import Model, forward, layer_plan

__all__ = ["Model", "ModelBundle", "build", "forward", "layer_plan",
           "unsupported"]
