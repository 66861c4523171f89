"""Device meshes over ``torch.distributed``.

Port of ``repro/launch/mesh.py``. JAX sees every local device in one
process; here each device is a rank of a process group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over that group's ranks. The
group is the caller's, or ``process_group``'s: gloo for the CPU, NCCL for
the card, a ``file://`` rendezvous under a fresh temporary directory, one
rank unless told otherwise (nothing on the card's machine names a
cluster). Importing this module touches no device and starts nothing.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


@contextlib.contextmanager
def process_group(device="cuda", *, rank: int = 0, world_size: int = 1, init_method=None):
    """The default process group for the block: gloo for ``device="cpu"``,
    NCCL for the card, rendezvous by ``init_method`` (default a
    ``file://`` path in a fresh temporary directory, which a one-rank
    group needs alone). Destroyed, and the directory removed, on exit."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already set up")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("process_group(device='cuda') but no CUDA device is available; "
                           "pass device='cpu' explicitly")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def make_mesh(shape, axes, device="cuda"):
    """A mesh of ``shape`` named ``axes`` over the default group's ranks
    (their count must be the product of ``shape``)."""
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: (16, 16) = ("data", "model"), 256 devices. Multi-pod:
    (2, 16, 16) = ("pod", "data", "model"), 512. Raises unless the default
    group has exactly that many ranks: it never builds a smaller mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"the production mesh {shape} {axes} needs {need} devices; "
                           f"the process group has {have}")
    return make_mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ("data", "model") mesh over the default group's ranks (tests and
    examples)."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, the "
                         f"process group has {n}")
    return make_mesh((data, model), ("data", "model"), device)


def mesh_info(mesh) -> dict:
    return {
        "axis_names": tuple(mesh.mesh_dim_names),
        "shape": tuple(mesh.shape),
        "num_devices": int(mesh.size()),
    }
