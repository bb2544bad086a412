"""Meshes: named axes over the ranks of a ``torch.distributed`` world.

Defined as FUNCTIONS (not module constants) so importing this module
touches no process group and no device.

Single pod:  (16, 16)    axes ("data", "model")       = 256 ranks
Multi pod:   (2, 16, 16) axes ("pod", "data", "model") = 512 ranks

The sharding discipline (launch/shardings.py):
  * batch over ("pod", "data") — pure DP across pods (cheapest inter-pod
    traffic: one gradient all-reduce per step);
  * weights 2D-sharded: "model" = tensor parallel (heads / d_ff / experts /
    vocab), "data" = FSDP (ZeRO-3 style parameter+optimizer sharding);
  * elastic: any (data, model) shape works — checkpoints are mesh-agnostic
    and restore reshards (checkpoint/ckpt.py).

A ``Mesh`` carries ``shape``, a mapping of axis name to size in mesh
order: the sharding rules read only that (``mesh.shape[axis]``,
``axis in mesh.shape``), so any object with such a ``shape`` stands in for
a mesh there. Its ``device_mesh`` is the ``torch.distributed`` one that
places tensors and names the groups of each axis.

``run_world`` starts a world of ranks on this machine (``spawn``, a
``FileStore`` under a directory of the caller's, the backend the caller
names), as ``launch.train --mesh`` does.
"""
from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: dict[str, int]       # axis name -> size, in mesh order
    device_mesh: Any = None     # torch.distributed DeviceMesh

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> Mesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the world
    (``init_device_mesh``; it joins the world of ``torchrun``'s
    environment when no process group exists yet). ``device_type`` is the
    card unless the caller asks for the host (``"cpu"``, gloo ranks)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device and none is "
                           "available; pass device_type='cpu' for gloo "
                           "ranks on the host")
    if dist.is_initialized() and math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axes, shape))} has "
                         f"{math.prod(shape)} ranks; the world has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return Mesh(shape=dict(zip(axes, shape)), device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if world_size() < need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {need} "
            f"ranks; this world has {world_size()} (use make_mesh for an "
            "elastic shape)")
    return make_mesh(shape, axes, device_type)


def make_fleet_mesh(n_devices: int, device_type: str = "cuda") -> Mesh:
    """1-D mesh for the simulated-eGPU fleet (``core.fleet``): axis
    ``"fleet"`` carries one simulated device per rank."""
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} must be >= 1")
    if n_devices > world_size():
        raise ValueError(
            f"fleet mesh wants {n_devices} ranks but the world has "
            f"{world_size()}; start one rank per device or use "
            "placement='host'")
    return make_mesh((n_devices,), ("fleet",), device_type)


def data_axes(mesh) -> tuple[str, ...]:
    """The axes a batch dimension shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_divisor(mesh) -> int:
    d = 1
    for a in data_axes(mesh):
        d *= mesh.shape[a]
    return d


# ---------------------------------------------------------------------------
# a world of ranks on this machine
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               store: str, timeout_s: float, threads: int, args: tuple):
    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, store_dir: str, *args,
              backend: str, timeout_s: float = 60.0,
              threads: int = 1) -> None:
    """Run ``fn(rank, *args)`` on ``world`` fresh ranks (``spawn``), each
    in a process group of ``backend`` (``"nccl"``: rank r on card r;
    ``"gloo"``: the host) set up through a ``FileStore`` in
    ``store_dir`` (which must hold no ``store`` file yet), with
    ``threads`` intra-op threads a rank and a collective ``timeout_s``.
    ``fn`` must be importable by name. A rank that raises ends the world,
    and the error is raised here."""
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        raise FileExistsError(f"{store} exists: a FileStore wants a new file")
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, backend, store, timeout_s, threads,
                          args),
        nprocs=world, start_method="spawn")
