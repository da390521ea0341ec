"""Elastic re-meshing: recover the largest valid production mesh after
node loss and re-shard a checkpointed state onto it.

Counterpart of ``repro/train/elastic.py``.  The contract a 1000-node
deployment needs:
  1. detect the surviving rank set,
  2. choose the largest (pod, data, model) mesh the survivors can form
     while keeping the model-axis size (the tensor- and expert-parallel
     degree must not change: weights are sharded by it); data and pod
     axes absorb the loss,
  3. recompute placements from the SAME logical rules and restore from
     the last checkpoint (the data pipeline is a pure function of step,
     so no input state is lost).

The mesh is a ``DeviceMesh`` over the first ``prod(shape)`` survivors;
building it is collective over the process group, so every rank calls
:func:`remesh`, survivors or not.  :func:`reshard_state` places a state
that every rank restored on the host (numpy arrays or CPU tensors, as
:func:`~repro_torch.train.restore_checkpoint` gives them) onto the mesh:
each rank keeps its own block and nothing is sent.
"""

from __future__ import annotations

import numpy as np

__all__ = ["largest_submesh_shape", "remesh", "reshard_state"]


def largest_submesh_shape(n_devices: int, model_axis: int,
                          prefer_pods: int = 2) -> tuple[int, ...]:
    """Largest (pod, data, model) with pod*data*model <= n_devices, model
    fixed, pod in {prefer_pods, ..., 1}, data maximal."""
    if n_devices < model_axis:
        raise ValueError(f"cannot keep model axis {model_axis} with only "
                         f"{n_devices} devices")
    for pods in range(prefer_pods, 0, -1):
        data = n_devices // (model_axis * pods)
        if data >= 1:
            if pods == 1:
                return (data, model_axis)
            return (pods, data, model_axis)
    raise ValueError("no valid submesh")


def remesh(ranks, model_axis: int, prefer_pods: int = 2, device_type=None):
    """The survivor mesh over the first ``prod(shape)`` of ``ranks`` (a
    list of process-group ranks), ``("pod", "data", "model")`` or
    ``("data", "model")``, on ``device_type`` (default: the card;
    ``"cpu"`` for gloo).  Opens a one-rank group where none exists and
    ``ranks`` is ``[0]``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .._device import resolve_device
    device_type = resolve_device(device_type).type
    ranks = [int(r) for r in ranks]
    shape = largest_submesh_shape(len(ranks), model_axis, prefer_pods)
    n = int(np.prod(shape))
    if not dist.is_initialized() and ranks[:n] == [0]:
        from ..launch.mesh import one_rank_group
        one_rank_group(device_type)
    names = ("pod", "data", "model") if len(shape) == 3 else \
        ("data", "model")
    return DeviceMesh(device_type, torch.tensor(ranks[:n]).reshape(shape),
                      mesh_dim_names=names)


def reshard_state(state, mesh, state_specs):
    """A host-restored state (a dict tree of numpy arrays, numbers or
    CPU tensors) as DTensors on ``mesh`` by ``state_specs`` (the same
    tree of specs).  Each rank keeps its block of the host copy it holds
    (``src_data_rank=None``): no value is sent."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ..models.common import placements

    if isinstance(state, dict):
        return {k: reshard_state(v, mesh, state_specs[k])
                for k, v in state.items()}
    t = torch.as_tensor(np.asarray(state) if not isinstance(
        state, torch.Tensor) else state)
    dev = torch.device(mesh.device_type)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return distribute_tensor(t.to(dev), mesh, placements(state_specs, mesh),
                             src_data_rank=None)
