"""The production and host meshes of the port.

Counterpart of ``repro/launch/mesh.py``.  ``make_production_mesh`` and
``make_host_mesh`` are functions: importing this module touches no
process group and no device.  The production mesh is 16 x 16 = 256
devices a pod, (2, 16, 16) = 512 over two pods; the ``pod`` axis is the
slow (inter-pod, projective-fabric) dimension that data parallelism and
pipeline stages map onto, ``data`` and ``model`` are intra-pod.  A
``DeviceMesh`` needs a process group with a rank per device: a cluster's
(``torch.distributed.init_process_group`` under a launcher), or, for a
dry run of one rank's share on one card, the fake group that
:mod:`repro_torch.launch.dryrun` opens.
"""

from __future__ import annotations

__all__ = ["PRODUCTION_SHAPES", "make_production_mesh", "make_host_mesh",
           "one_rank_group"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over a process group of
    exactly 256 (512) ranks; raises ``RuntimeError`` otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        have = "no process group" if world is None else \
            f"a process group of {world} ranks"
        raise RuntimeError(
            f"the production mesh {shape} needs a process group of {n} "
            f"ranks and this process has {have}; for one rank's share of "
            f"a production-mesh step on one card run `python -m "
            f"repro_torch.launch.dryrun --mesh "
            f"{'pod2' if multi_pod else 'pod1'}`")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, device_type=None):
    """A ``("data", "model")`` mesh over ranks ``0 .. data * model - 1`` of
    the process group, on ``device_type`` (default: the card; ``"cpu"``
    for gloo).  With no process group, a (1, 1) mesh opens a one-rank
    group of its own; larger meshes raise."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .._device import resolve_device
    device_type = resolve_device(device_type).type
    n = data * model
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a ({data}, {model}) mesh needs a process "
                               f"group of at least {n} ranks")
        one_rank_group(device_type)
    if dist.get_world_size() < n:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {n} ranks; the "
                           f"process group has {dist.get_world_size()}")
    ranks = torch.arange(n).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def one_rank_group(device_type: str = "cpu") -> None:
    """Open a process group of this process alone (NCCL for the card,
    gloo for the CPU), for a one-device mesh where no group exists."""
    import torch.distributed as dist
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
