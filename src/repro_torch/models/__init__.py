"""The model substrate of the port: GQA attention, MLA, Mamba-2 SSD and
RG-LRU blocks, dense MLPs and MoE, the decoder, the loss and the
bundle."""

from .model import ModelBundle, build, loss_fn, unsupported
from .transformer import Model, forward, layer_plan

__all__ = ["Model", "ModelBundle", "build", "forward", "layer_plan",
           "loss_fn", "unsupported"]
