"""The model substrate of the port: GQA attention and gated
cross-attention, MLA, Mamba-2 SSD and RG-LRU blocks, dense MLPs and MoE,
the encoder, the decoder, the loss and the bundle."""

from .model import (ModelBundle, build, cache_logical_axes, cache_specs,
                    loss_fn, place_params)
from .transformer import (Model, count_params, forward, layer_plan,
                          layers_of, model_flops)

__all__ = ["Model", "ModelBundle", "build", "cache_logical_axes",
           "cache_specs", "count_params", "forward", "layer_plan",
           "layers_of", "loss_fn", "model_flops", "place_params"]
