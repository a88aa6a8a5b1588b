"""Production mesh construction (port of ``repro.launch.mesh``).

A FUNCTION, not a module-level constant: importing this module touches no
process group. ``make_production_mesh`` validates the shape as the
reference does and builds a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names — ("data", "model"), or ("pod", "data", "model") —
over the ranks of the default process group, which must number exactly
the mesh's size. A 1-rank mesh starts its own 1-rank group where none
exists; a larger one needs its ranks started first
(``repro_torch.launch.serve`` spawns them, or ``torchrun``).

The backend is NCCL on ``cuda`` and gloo on ``cpu`` unless the caller names
one. Under NCCL each rank needs a card of its own: a mesh larger than
``torch.cuda.device_count()`` raises, and nothing drops to fewer ranks or
to gloo. Gloo on the card (several ranks sharing one card, their
collectives through host memory) is taken only where the caller names it.
With a pod axis the mesh also carries the data-parallel group over
("pod", "data") as ``repro_dp_group`` (``sharding.tp.dp_group``).
"""
from __future__ import annotations

import math
import socket
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def check_shape(shape=None, multi_pod: bool = False) -> tuple:
    """The mesh shape as the reference validates it: 2 (data, model) or 3
    (pod, data, model) positive ints; None gives the production pod."""
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) not in (2, 3) or any(s < 1 for s in shape):
            raise ValueError(
                f"mesh shape must be 2 (data, model) or 3 (pod, data, model) "
                f"positive ints, got {shape!r}")
        return shape
    return (2, 16, 16) if multi_pod else (16, 16)


def mesh_backend(device, backend: Optional[str] = None) -> str:
    """The backend a mesh on ``device`` takes: ``backend`` where named,
    else NCCL on the card and gloo on the CPU."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"mesh backend {backend!r}: one of {BACKENDS}")
    return backend


def check_fits(shape: tuple, device, backend: str) -> None:
    """Raise where the mesh cannot be held: NCCL needs a card a rank (it
    refuses two ranks on one device), and NCCL runs on the card only."""
    need = math.prod(shape)
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend runs on the card; a CPU mesh "
                             "takes gloo")
        have = torch.cuda.device_count()
        if need > have:
            raise ValueError(
                f"mesh {'x'.join(map(str, shape))} needs {need} ranks, one "
                f"card each under NCCL, but torch sees {have} card(s); name "
                f"the gloo backend to run several ranks on one card")


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device="cuda", backend: Optional[str] = None):
    """Single pod 16 x 16 ("data", "model"); multi-pod adds a leading "pod"
    axis (2 x 16 x 16). ``shape`` overrides the grid: a 2-tuple builds
    ("data", "model"), a 3-tuple ("pod", "data", "model")."""
    shape = check_shape(shape, multi_pod)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    dev = torch.device(device)
    backend = mesh_backend(dev, backend)
    check_fits(shape, dev, backend)
    need = math.prod(shape)
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(
                f"mesh {'x'.join(map(str, shape))} needs {need} ranks: start "
                f"them first (repro_torch.launch.serve spawns them, or "
                f"torchrun) and init the process group")
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    if dist.get_world_size() != need:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {need} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"the process group runs {have!r}, the mesh asks "
                         f"for {backend!r}")
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)
    if len(shape) == 3:
        # the (pod, data) group of each model index, created on every rank
        # in the same order
        grid = torch.arange(need).reshape(shape[0] * shape[1], shape[2])
        me = dist.get_rank()
        for m in range(shape[2]):
            ranks = grid[:, m].tolist()
            group = dist.new_group(ranks, backend=backend)
            if me in ranks:
                mesh.repro_dp_group = group
    return mesh
