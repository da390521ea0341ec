"""The model substrate of the port: GQA attention and Mamba-2 SSD
blocks, the decoder, the loss and the bundle."""

from .model import ModelBundle, build, loss_fn, unsupported
from .transformer import Model, forward, layer_plan

__all__ = ["Model", "ModelBundle", "build", "forward", "layer_plan",
           "loss_fn", "unsupported"]
