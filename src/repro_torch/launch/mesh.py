"""Production mesh construction (port of ``repro.launch.mesh``).

A FUNCTION, not a module-level constant: importing this module touches no
process group. ``make_production_mesh`` validates the shape as the
reference does and builds a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names — ("data", "model"), or ("pod", "data", "model") —
over the ranks of the default process group, which must number exactly
the mesh's size. A 1-rank mesh starts its own 1-rank group where none
exists; a larger one needs its ranks started first
(``spawn_ranks``, as the serve and train launchers do, or ``torchrun``).

The backend is NCCL on ``cuda`` and gloo on ``cpu`` unless the caller names
one. Under NCCL each rank needs a card of its own: a mesh larger than
``torch.cuda.device_count()`` raises, and nothing drops to fewer ranks or
to gloo. Gloo on the card (several ranks sharing one card, their
collectives through host memory) is taken only where the caller names it.
With a pod axis the mesh also carries the data-parallel group over
("pod", "data") as ``repro_dp_group`` (``sharding.tp.dp_group``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import shutil
import signal
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

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


@dataclasses.dataclass
class RankFailure:
    """What a spawned rank that raised hands back: its exception, its
    traceback and when it was caught (``time.time()``)."""
    error: BaseException
    traceback: str
    at: float


def _rank_entry(rank: int, world: int, store: str, backend: str,
                split_threads: bool, drain: bool, body: Callable,
                args: tuple, out: str) -> None:
    """A spawned rank: join the process group over the file ``store``, run
    ``body(*args)`` (with ``drain_file=`` where ``drain``), and write rank
    0's result to ``<out>.0``; a rank that fails writes a ``RankFailure``
    to ``<out>.<rank>`` and exits non-zero. The failure is stamped before
    the rank leaves the group, so a peer that fails because it left (a
    collective's connection closed) stamps a later time."""
    if drain:
        # a signal could interrupt a collective: the launcher turns its own
        # SIGTERM into the drain file, which the body reads
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    if split_threads:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    result = None
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            result = body(*args, **({"drain_file": f"{out}.drain"}
                                    if drain else {}))
        except BaseException as e:           # reported to the parent
            result = RankFailure(e, traceback.format_exc(), time.time())
        finally:
            dist.destroy_process_group()
    except BaseException as e:               # joining or leaving the group
        if not isinstance(result, RankFailure):
            result = RankFailure(e, traceback.format_exc(), time.time())
    sys.stdout.flush()
    if rank == 0 or isinstance(result, RankFailure):
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(result, f)
    if isinstance(result, RankFailure):
        # a non-zero exit: the parent stops the other ranks at once
        sys.exit(1)


def spawn_ranks(body: Callable, args: tuple, world: int, backend: str, *,
                split_threads: bool, drain: bool = False,
                raise_as_is: tuple = ()) -> Any:
    """Run ``body(*args)`` on ``world`` spawned ranks joined over a file
    store (``body`` and ``args`` must pickle), wait for them, and return
    rank 0's result. A rank that fails exits non-zero and leaves the others
    waiting in a collective: they are stopped at once, and the earliest
    failure is raised here (as it is where its type is in ``raise_as_is``,
    else as a ``RuntimeError`` with the rank's traceback).
    ``split_threads`` divides the host's threads among the ranks (ranks on
    the CPU). ``drain``: the ranks ignore SIGTERM, and a SIGTERM to this
    process writes the drain file that ``body`` gets as ``drain_file=``."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    out = os.path.join(tmp, "run")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, world, os.path.join(tmp, "store"),
                                   backend, split_threads, drain, body, args,
                                   out))
                 for r in range(world)]
        sys.stdout.flush()
        for p in procs:
            p.start()
        prev = (signal.signal(signal.SIGTERM,
                              lambda *_: open(f"{out}.drain", "w").close())
                if drain else None)
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    for p in procs:
                        p.kill()
                time.sleep(0.05)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)
        results = {}
        for r in range(world):
            try:
                with open(f"{out}.{r}", "rb") as f:
                    results[r] = pickle.load(f)
            except (OSError, EOFError, pickle.UnpicklingError):
                pass          # none written, or stopped while writing
        failed = sorted((res.at, r) for r, res in results.items()
                        if isinstance(res, RankFailure))
        for _, r in failed:
            if isinstance(results[r].error, raise_as_is):
                raise results[r].error
            raise RuntimeError(f"mesh rank {r} failed:\n"
                               f"{results[r].traceback}")
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad or 0 not in results:
            raise RuntimeError(f"mesh ranks {bad} exited with codes "
                               f"{[procs[r].exitcode for r in bad]}")
        return results[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
