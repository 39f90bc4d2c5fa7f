"""Production meshes (twin of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches no
device or process group.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..sharding.api import AbstractMesh, abstract_mesh

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production mesh of GPUs: one pod = 16 x 16 = 256 ranks, two pods
    512. "pod" extends data parallelism across pods (only the gradient
    reduction and the batch split cross it), "data" is in-pod data
    parallelism, "model" the tensor/expert/sequence-parallel axis. Needs a
    process group of exactly that many ranks (``torchrun`` or
    ``init_process_group`` with the world size), and raises otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} "
                           f"needs {need} ranks, the process group has {have}; "
                           "use make_test_mesh for a smaller one")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Device-free production mesh for planners and spec generation."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return abstract_mesh(shape, axes)


def make_test_mesh(shape: Tuple[int, ...] = (2, 4),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device: Optional[str] = None):
    """A small mesh over the current process group (world size =
    prod(shape)); on the card unless ``device="cpu"`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))
