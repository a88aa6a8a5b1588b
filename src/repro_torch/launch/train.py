"""Training launcher — port of ``repro.launch.train``: mesh → train step →
fault-tolerant loop (checkpoint and restore, preemption, stragglers) →
metrics, on the card unless told otherwise.

    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \
        --device cpu --steps 20 --ckpt-dir /tmp/train_ckpt
    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 60 \
        --batch 8 --seq 256 --ckpt-dir /tmp/train_ckpt --ckpt-every 40
    python -m repro_torch.launch.train --smoke --device cpu --mesh 2x1 \
        --steps 6 --ckpt-dir /tmp/train_mesh
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --steps 60

The reference's flags and defaults, plus ``--device`` (default the card;
``cpu`` runs the plain PyTorch ops), ``--layers N`` (the arch cut to its
first N layers, widths kept), ``--mesh DxM`` and ``--mesh-backend``. The
schedule (``peak_lr`` 1e-3, 20 warmup steps, the cosine over ``--steps``),
the data (``TokenStream`` of seed 0, shard 0 of 1: the global batch, of
which each rank takes its rows), the checkpointer (the last 2 kept), the
straggler monitor (threshold 3) and the printed lines (rank 0's) are the
reference's. The initial weights are ``model.init(0)`` on the device
(``torch.Generator`` draws: not the JAX package's), whole on every rank
and then cut to its blocks.

The mesh is the reference's (devices, 1): under ``torchrun`` the job's
world, otherwise one rank a visible card (spawned, over a file store, as
``launch.serve`` spawns a serving mesh); on one card, or the CPU, one
device and no mesh. ``--mesh`` names another shape (("data", "model"), or
("pod", "data", "model")); the backend follows ``launch.mesh``'s rules —
NCCL on the card, a card a rank; gloo on the CPU; ``--mesh-backend gloo``
runs several ranks on one card, their collectives through host memory.
Over a mesh the train step is ``launch.steps``' under
``configure_sharding_hints``, checkpoints gather whole and rank 0 writes
them (``Checkpointer.on_mesh``), ``--resume`` restores onto the mesh at
hand whatever the mesh that wrote it (``runtime.elastic_restore``), the
loop agrees on retries and preemption over the ranks, and a rank that
fails exits non-zero: the launcher then ends every rank.

``main`` returns a ``TrainRun`` (rank 0's): the final ``(params,
AdamWState)`` (whole: gathered over a mesh) and where the run ended, every
step's loss and wall time, the loop's metrics and, over a mesh, each
rank's resident bytes beside the planner's and its peak device memory,
for a caller to use (the tests, ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import TokenStream
from ..device import resolve_device
from ..models import ModelConfig
from ..optim import adamw_init
from ..runtime import (
    FaultTolerantLoop,
    LoopMetrics,
    StragglerMonitor,
    elastic_restore,
)
from ..sharding.partition import (
    block_bytes,
    named_shardings,
    opt_spec_tree,
    shard_tree,
    unshard_tree,
)
from .steps import (
    clear_sharding_hints,
    configure_sharding_hints,
    make_train_step,
    state_specs,
)

#: the reference launcher's schedule, the cosine over ``--steps``
LR_SCHEDULE = {"peak_lr": 1e-3, "warmup": 20}


@dataclasses.dataclass
class TrainRun:
    """What one ``main`` call did."""

    state: tuple                 # (params, AdamWState) at ``end``
    start: int                   # the step it started (or resumed) at
    end: int                     # the step it stopped at
    losses: list                 # each step_fn call's loss, replays included
    step_seconds: list           # each step_fn call's wall time, loss read
    metrics: LoopMetrics
    cfg: ModelConfig
    model: Any
    mesh: Optional[tuple] = None     # the mesh's shape (None: one device)
    backend: Optional[str] = None
    # over a mesh, each rank's {"resident": bytes of its params and AdamW
    # blocks, "planned": the planner's block bytes of the same, "peak":
    # its peak device memory (None on the CPU)}
    ranks: Optional[list] = None


class FailOnce:
    """The loop's failure hook for a launcher call (picklable, so spawned
    ranks take it): True the first time it sees ``step``."""

    def __init__(self, step: int):
        self.step, self.fired = step, False

    def __call__(self, step: int) -> bool:
        if step == self.step and not self.fired:
            self.fired = True
            return True
        return False


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to its first N layers, widths kept")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DxM (or PxDxM): the mesh to train over (default "
                         "the reference's (devices, 1))")
    ap.add_argument("--mesh-backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's backend (default NCCL on the card, "
                         "gloo on the CPU)")
    return ap


def _mesh_shape(args) -> Optional[tuple]:
    """The mesh to train over, None for one device: ``--mesh``, else
    (devices, 1) — torchrun's world, else the visible cards."""
    if args.mesh is not None:
        from .serve_config import parse_mesh

        return parse_mesh(args.mesh)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    elif torch.device(args.device).type == "cuda":
        world = torch.cuda.device_count()
    else:
        world = 1
    return (world, 1) if world > 1 else None


def main(argv: Optional[list] = None, *,
         inject_failure: Optional[Callable[[int], bool]] = None,
         preempt_at: Optional[int] = None) -> TrainRun:
    """Train per ``argv`` (default: the command line). For callers that
    drive the fault path: ``inject_failure(step)`` is the loop's test hook
    (a step it returns True for raises, and the loop restores and
    replays; over spawned ranks it must pickle: ``FailOnce``), and
    ``preempt_at`` requests a preemption once that many steps are done
    (the loop checkpoints at that boundary and returns)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.layers is not None and args.layers < 1:
        raise SystemExit("--layers must be >= 1")
    device = resolve_device(args.device)
    shape = _mesh_shape(args)
    if shape is None:
        return _train(args, None, inject_failure, preempt_at)
    from .mesh import check_fits, mesh_backend

    backend = mesh_backend(device, args.mesh_backend)
    check_fits(shape, device, backend)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    if math.prod(shape) == 1 or (dist.is_initialized() and
                                 dist.get_world_size() == math.prod(shape)):
        # (a 1-rank mesh starts its own group in this process)
        return _train_rank(args, shape, backend, inject_failure, preempt_at)
    from .mesh import spawn_ranks

    return spawn_ranks(_spawned_rank,
                       (argv, shape, backend, inject_failure, preempt_at),
                       math.prod(shape), backend,
                       split_threads=device.type == "cpu")


def _train_rank(args, shape, backend, inject_failure, preempt_at) -> TrainRun:
    """This process's rank of the mesh: build the mesh over the running
    process group and train (rank 0 prints)."""
    from .mesh import make_production_mesh

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_production_mesh(shape=shape, device=device, backend=backend)
    with contextlib.ExitStack() as quiet:
        if dist.get_rank():
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        print("mesh: " + ", ".join(f"{a}={n}" for a, n in zip(
            mesh.mesh_dim_names, mesh.shape)) + f" over {backend} on {device}")
        run = _train(args, mesh, inject_failure, preempt_at)
    run.mesh, run.backend = tuple(shape), backend
    return run


def _train(args, mesh, inject_failure, preempt_at) -> TrainRun:
    """The reference's ``main`` over ``mesh`` (None: one device)."""
    device = resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    # donated, as the reference jits its step (donate_argnums=(0, 1)):
    # AdamW updates the params and moments in place
    model, train_step = make_train_step(
        cfg, lr_cfg=dict(LR_SCHEDULE, total=args.steps), donate=True)
    if mesh is not None:
        configure_sharding_hints(cfg, mesh)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
    try:
        return _loop(args, cfg, model, train_step, mesh, device,
                     inject_failure, preempt_at)
    finally:
        if mesh is not None:
            clear_sharding_hints()


def _loop(args, cfg, model, train_step, mesh, device, inject_failure,
          preempt_at) -> TrainRun:
    params = model.init(0, device=device)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    loop_ckpt, group, heads = ckpt, None, {"n_q": cfg.n_heads,
                                           "n_kv": cfg.n_kv_heads}
    if mesh is not None:
        # every rank draws the same whole init and keeps its blocks
        shapes, (p_spec, _) = state_specs(model, mesh)
        specs = (p_spec, opt_spec_tree(p_spec))
        params = shard_tree(params, p_spec, mesh)
        loop_ckpt = ckpt.on_mesh(shapes, named_shardings(specs, mesh))
        group = dist.group.WORLD
    opt = adamw_init(params)
    stream = TokenStream(seed=0, shard=0, n_shards=1,
                         batch_per_shard=args.batch, seq=args.seq,
                         vocab=cfg.vocab_size, device=device)

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = train_step(params, opt, batch)
        return (params, opt), {"loss": float(metrics["loss"])}

    mon = StragglerMonitor(threshold=3.0)
    loop = FaultTolerantLoop(step_fn, lambda s: stream.batch(s), loop_ckpt,
                             ckpt_every=args.ckpt_every, straggler=mon,
                             group=group)
    state = (params, opt)
    start = 0
    if args.resume and loop_ckpt.latest_step() is not None:
        if mesh is None:
            state, start = ckpt.restore(state)
        else:
            # the checkpoint is mesh-independent: onto this mesh
            state, start = elastic_restore(ckpt, shapes, mesh, heads=heads)
        print(f"resumed from step {start}")

    t0 = time.time()
    losses, seconds = [], []
    orig_step = loop.step_fn

    def logging_step(state, batch):
        t = time.perf_counter()
        state, m = orig_step(state, batch)
        seconds.append(time.perf_counter() - t)
        losses.append(m["loss"])
        n = len(losses) + start
        if n % args.log_every == 0:
            print(f"step {n}: loss {np.mean(losses[-args.log_every:]):.4f} "
                  f"({(time.time() - t0) / len(losses):.2f}s/step)",
                  flush=True)
        if preempt_at is not None and n == preempt_at:
            loop.request_preemption()
        return state, m

    loop.step_fn = logging_step
    state, end = loop.run(state, start, args.steps - start,
                          inject_failure=inject_failure)

    print(f"done at step {end}; loss {np.mean(losses[-10:]):.4f} "
          f"(start {np.mean(losses[:10]):.4f}); "
          f"straggler events: {loop.metrics.straggler_events}; "
          f"retries: {loop.metrics.retries}")
    ranks = None
    if mesh is not None:
        mine = {"resident": sum(t.numel() * t.element_size()
                                for t in _tensors(state)),
                "planned": block_bytes(shapes, specs, mesh),
                "peak": (torch.cuda.max_memory_allocated()
                         if device.type == "cuda" else None)}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        state = unshard_tree(state, specs, mesh)
    return TrainRun(state=state, start=start, end=end, losses=losses,
                    step_seconds=seconds, metrics=loop.metrics, cfg=cfg,
                    model=model, ranks=ranks)


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


def _spawned_rank(argv: list, shape: tuple, backend: str, inject_failure,
                  preempt_at) -> TrainRun:
    """A spawned rank (``launch.mesh.spawn_ranks``): train, and hand rank
    0's run back with its state on the host."""
    run = _train_rank(build_parser().parse_args(argv), shape, backend,
                      inject_failure, preempt_at)
    if dist.get_rank() == 0:
        run.state = _to_host(run.state)
        # the model's caches hold device tensors and the mesh's groups
        run.model._prepared = None
        vars(run.model).pop("_train_shard", None)
    return run


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [_to_host(v) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(
            kids)
    return tree.cpu()


if __name__ == "__main__":
    main()
