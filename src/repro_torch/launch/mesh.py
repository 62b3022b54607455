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

A mesh of several ranks that moves data runs in local processes:
:func:`run_on_ranks` starts ``world`` of them over a ``FileStore`` in a
temporary directory (gloo, the CPU, no port and no network), and each
builds its mesh with :func:`make_mesh`. The card's machine has one GPU,
and NCCL refuses two ranks on one device, so several ranks run on the
CPU.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
import traceback
from typing import Callable

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


def make_mesh(shape: tuple, names: tuple, device_type: str = "cpu"):
    """A ``shape`` mesh with axes ``names`` over the first ``prod(shape)``
    ranks of the initialized group (:func:`run_on_ranks` makes one)."""
    from torch.distributed.device_mesh import init_device_mesh
    _require_group(math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def _rank_main(fn: Callable, rank: int, world: int, path: str,
               args: tuple) -> None:
    """One rank of :func:`run_on_ranks`: its group, ``fn(*args)``, and
    the result (or the traceback) pickled to ``path``/<rank>."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = os.path.join(path, str(rank))
    try:
        store = dist.FileStore(os.path.join(path, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            result = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except Exception:           # every failure goes back to the caller
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


def _read(path: str, rank: int):
    with open(os.path.join(path, str(rank)), "rb") as f:
        return pickle.load(f)


def _wait(procs: list, path: str, timeout: float) -> None:
    """Until every rank has ended; a rank's error, a rank that died
    without a result, or the deadline ends the wait at once (the other
    ranks may be blocked in a collective with it)."""
    import time
    deadline = time.monotonic() + timeout
    world = len(procs)
    while any(p.is_alive() for p in procs):
        for r, p in enumerate(procs):
            done = os.path.exists(os.path.join(path, str(r)))
            if done and _read(path, r)[0] == "error":
                return
            if not p.is_alive() and not done:
                return
        if time.monotonic() > deadline:
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            raise TimeoutError(f"run_on_ranks: ranks {late} of {world} "
                               f"still running after {timeout} s")
        time.sleep(0.02)


def run_on_ranks(fn: Callable, world: int, *args,
                 timeout: float = 600.0) -> list:
    """``fn(*args)`` on each of ``world`` local processes, rank r of a
    gloo group of ``world`` over a ``FileStore`` in a temporary directory
    (no port, no network), each on one CPU thread; the ranks' results in
    rank order. ``fn`` and ``args`` must pickle (a module-level function).
    An exception in any rank raises here with that rank's traceback; a
    rank that dies or outlives ``timeout`` seconds raises too, and every
    process is stopped first."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as path:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, path, args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _wait(procs, path, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        got = {r: _read(path, r) for r in range(world)
               if os.path.exists(os.path.join(path, str(r)))}
        for r, (status, value) in sorted(got.items()):
            if status == "error":
                raise RuntimeError(f"run_on_ranks: rank {r} of {world} "
                                   f"failed:\n{value}")
        for r, p in enumerate(procs):
            if r not in got:
                raise RuntimeError(f"run_on_ranks: rank {r} of {world} "
                                   f"ended with exit code {p.exitcode} and "
                                   f"no result")
        return [got[r][1] for r in range(world)]


def mesh_axes(mesh) -> dict:
    """The axis roles present in ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    dp_axes = tuple(n for n in names if n in ("pod", "data"))
    return {"dp_axes": dp_axes, "tp_axis": "model",
            "dp_total": math.prod(sizes[n] for n in dp_axes),
            "tp": sizes.get("model", 1)}


__all__ = ["PRODUCTION_SHAPES", "fake_process_group", "make_host_mesh",
           "make_mesh", "make_production_mesh", "mesh_axes", "run_on_ranks"]
