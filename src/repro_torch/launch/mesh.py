"""Mesh construction, the counterpart of ``repro/launch/mesh.py``.
Importing this module touches no device and starts no process group.

:func:`make_production_mesh` is shape only: one process cannot hold a
256- or 512-rank ``DeviceMesh``, so it returns a :class:`MeshShape`,
named axis sizes as jax's ``AbstractMesh`` has them, which the sharding
rules (``repro_torch.distributed.sharding``) and the cell plans
(``repro_torch.launch.specs``) read.  :func:`make_host_mesh` is a real
one-rank ``DeviceMesh`` with the same axis names, for runs on one
device.  :func:`make_fake_mesh` is a ``DeviceMesh`` of a ``MeshShape``'s
full size over a fake process group, every rank in this process and no
byte sent: the dry run (``repro_torch.launch.dryrun``) traces each
cell's step on it as DTensors, and :func:`end_fake_group` ends it.
"""
from __future__ import annotations

import atexit
import math
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


FAKE = "fake"


def _running_fake() -> bool:
    return dist.is_initialized() and str(dist.get_backend()) == FAKE


def make_fake_mesh(shape: MeshShape) -> DeviceMesh:
    """A ``DeviceMesh`` on ``"cpu"`` with ``shape``'s axis names and
    sizes over a fake process group of ``prod(sizes)`` ranks, all in
    this process: collectives on it send nothing and return tensors of
    the right shape, which is all a trace on fake tensors reads.  With
    no process group running this starts one (rank 0); a running group
    must be fake and of that size.  One group serves one size, so a
    caller that goes from the 256-rank mesh to the 512-rank one ends the
    group between them (:func:`end_fake_group`)."""
    n = math.prod(shape.axis_sizes)
    if not dist.is_initialized():
        # importing the module registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group(FAKE, store=FakeStore(), rank=0,
                                world_size=n)
    elif not _running_fake() or dist.get_world_size() != n:
        raise RuntimeError(
            f"make_fake_mesh: a process group of {dist.get_world_size()} "
            f"rank(s) on {dist.get_backend()!r} is running; a "
            f"{shape.axis_sizes} fake mesh needs {n} ranks on {FAKE!r} "
            f"(end_fake_group() ends a fake group of another size)")
    return init_device_mesh("cpu", shape.axis_sizes,
                            mesh_dim_names=shape.axis_names)


def end_fake_group() -> bool:
    """Destroy the running process group if it is a fake one; a group on
    any other backend is left alone.  True if a group was ended."""
    if not _running_fake():
        return False
    dist.destroy_process_group()
    return True
