"""Device meshes (production shapes and this host's) over
``torch.distributed``.

Functions, not module-level constants: importing this module touches no
device and starts no process group.

A process that opens no group itself gets a single-rank one from
``ensure_process_group``, on an in-process ``HashStore`` (no TCP port, no
environment variables): NCCL for CUDA tensors (gloo beside it for CPU
ones) when it is opened for the card, gloo alone on the CPU. It is opened
once per process and never torn down here, so every later mesh in the
process reuses it.
"""
from __future__ import annotations

import torch

from ..models.cnn import resolve_device


def ensure_process_group(device_type: str) -> None:
    """Open the process's single-rank group for ``device_type`` unless one
    is open. A group already open on another backend is kept (a mesh over
    it needs that backend to support the device)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    # on the card the group serves CUDA tensors through NCCL and CPU ones
    # (a CPU mesh beside the card's) through gloo
    backend = "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(axis_shapes, axis_names, *, device=None):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    job's ranks (the JAX package's ``dist.compat.make_mesh``), on the card
    unless ``device`` asks for another device type."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = resolve_device(device).type
    ensure_process_group(device_type)
    n = 1
    for s in axis_shapes:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(axis_shapes)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: (16, 16) ``("data", "model")``, or (2, 16, 16)
    ``("pod", "data", "model")``, over CUDA devices. Raises when this
    process has fewer cards than it needs; it never shrinks the mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(f"the production mesh {shape} needs {need} CUDA devices "
                           f"in this process; it has {have}")
    return make_mesh(shape, axes, device="cuda")


def make_host_mesh(model: int = 1, device=None):
    """Whatever this job has (tests / examples): a ``(n // model, model)``
    ``("data", "model")`` mesh over its ``n`` ranks, one CUDA device each
    (``n`` is 1 in a process that opened its own group), or a ``(1, 1)``
    mesh on the CPU when ``device="cpu"`` is asked for. With no device
    given it wants the card, and raises without one."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch.distributed as dist
        ensure_process_group("cuda")
        n = dist.get_world_size()
        if n % model:
            raise ValueError(f"model={model} does not divide the job's {n} ranks")
        return make_mesh((n // model, model), ("data", "model"), device=dev)
    if model != 1:
        raise ValueError(f"a CPU mesh is (1, 1); model={model} asked for")
    return make_mesh((1, 1), ("data", "model"), device=dev)
