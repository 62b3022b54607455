"""Production meshes as ``torch.distributed`` device meshes (port of
``repro.launch.mesh``).

Importing this module touches no process-group state. A production mesh
(16 × 16 ``("data", "model")``, or 2 × 16 × 16 ``("pod", "data",
"model")``) needs an initialized process group of at least 256 or 512
ranks. On one host that is the fake group of :func:`fake_process_group`,
which holds no devices and moves no data: the dry run builds its
abstract arguments on it. The host mesh (1 × 1) runs a step: it
initializes a world-size-1 group over an in-process ``HashStore`` (NCCL
on the card, gloo on the CPU), which needs no network.
"""

from __future__ import annotations

import math

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def fake_process_group(world_size: int) -> None:
    """Make this process rank 0 of a fake group of ``world_size`` ranks
    (``torch.testing``'s ``FakeStore``): collectives return at once and
    move nothing. An initialized group of another size or backend is
    destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _require_group(n: int) -> None:
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() < n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a mesh of {n} devices needs an initialized process group of "
            f"at least {n} ranks (this process has {have}); on one host, "
            f"fake_process_group({n})")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 = 256 devices per pod; 2×16×16 = 512 multi-pod, over the
    first ranks of the initialized group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    _require_group(math.prod(shape))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """A 1×1 ``("data", "model")`` mesh for single-device runs through the
    same code paths; initializes a world-size-1 group if there is none."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> dict:
    """The axis roles present in ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    dp_axes = tuple(n for n in names if n in ("pod", "data"))
    return {"dp_axes": dp_axes, "tp_axis": "model",
            "dp_total": math.prod(sizes[n] for n in dp_axes),
            "tp": sizes.get("model", 1)}


__all__ = ["PRODUCTION_SHAPES", "fake_process_group", "make_host_mesh",
           "make_production_mesh", "mesh_axes"]
