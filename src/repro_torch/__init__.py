"""repro_torch — the PyTorch/CUDA port of the projective-network
toolkit, beside the JAX reference package ``repro``.

Ported so far, each with its hand-written Hopper kernels (``kernels``):
the flow-level simulator's main path (graph construction in ``core``,
route tables, the dense and the fused step in ``sim``); the analytic
arc-load engines, routing models and ``saturation_report`` (``core``);
the paper's topology families and the reference topologies (``core``,
``fabric.torus3d_graph``) and the fault model (``core.faults``,
``sim.faults``: degraded reports and sweeps, fault-aware tables, mid-run
fault events); the serving path of the dense-attention and Mamba-2
families (``configs``, ``models``, ``serve``, ``launch.serve``:
per-request prefill through the flash-attention and SSD-scan kernels,
batched greedy decode); and training of the dense-attention models
(``optim``, ``data``, ``train``, ``launch.train``).  Entry points run on the card unless the caller passes
``device="cpu"``.  The package imports torch, numpy and scipy, never
jax and never ``repro``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
