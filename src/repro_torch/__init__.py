"""repro_torch — the PyTorch/CUDA port of the projective-network
toolkit, beside the JAX reference package ``repro``.

This slice ports the flow-level simulator's main path: graph
construction (``core``), route tables, the dense and the fused step
(``sim``) and the two hand-written Hopper kernels the fused step runs
(``kernels``).  Entry points run on the card unless the caller passes
``device="cpu"``.  The package imports torch, numpy and scipy, never
jax and never ``repro``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
