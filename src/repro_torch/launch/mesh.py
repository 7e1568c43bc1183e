"""Mesh construction, the counterpart of ``repro/launch/mesh.py``.
Importing this module touches no device and starts no process group.

:func:`make_production_mesh` is shape only: one process cannot hold a
256- or 512-rank ``DeviceMesh``, so it returns a :class:`MeshShape`,
named axis sizes as jax's ``AbstractMesh`` has them, which the sharding
rules (``repro_torch.distributed.sharding``) and the cell plans
(``repro_torch.launch.specs``) read.  :func:`make_host_mesh` is a real
one-rank ``DeviceMesh`` with the same axis names, for runs on one
device.
"""
from __future__ import annotations

import atexit
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's named axis sizes, with no device behind it."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips a pod over ("data", "model"); 2 pods = 512
    chips over ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _end_group(tmp: tempfile.TemporaryDirectory) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    tmp.cleanup()


def _start_group(backend: str) -> None:
    """A one-rank default process group whose rendezvous is a file in a
    temporary directory, never a network address; it ends, and the
    directory goes, when the process exits."""
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_mesh_")
    if backend == "nccl":     # one process: NCCL's bootstrap stays local
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = dist.FileStore(os.path.join(tmp.name, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    atexit.register(_end_group, tmp)


def make_host_mesh(device=None) -> DeviceMesh:
    """A (1, 1) ``DeviceMesh`` over ("data", "model") on the GPU, or on
    ``device`` where the caller names one (``"cpu"``).  With no process
    group running, this starts a one-rank group: NCCL on the GPU, gloo
    on the CPU.  A running group must be of one rank and have the
    device's backend.  No GPU and no device named raises, as every entry
    point of the port does."""
    dev = resolve_device(device, "make_host_mesh")
    backend = BACKENDS.get(dev.type)
    if backend is None:
        raise ValueError(f"make_host_mesh: no process-group backend for "
                         f"{dev.type!r} (cuda or cpu)")
    if not dist.is_initialized():
        _start_group(backend)
    elif (dist.get_world_size() != 1
          or backend not in str(dist.get_backend())):
        raise RuntimeError(
            f"make_host_mesh: a process group of {dist.get_world_size()} "
            f"rank(s) on {dist.get_backend()!r} is running; a {dev.type} "
            f"host mesh needs one rank on {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
