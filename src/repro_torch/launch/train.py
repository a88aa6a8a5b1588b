"""Training launcher — port of ``repro.launch.train``: model → train step →
fault-tolerant loop (checkpoint and restore, preemption, stragglers) →
metrics, on the card unless told otherwise.

    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \
        --device cpu --steps 20 --ckpt-dir /tmp/train_ckpt
    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 60 \
        --batch 8 --seq 256 --ckpt-dir /tmp/train_ckpt --ckpt-every 40

The reference's flags and defaults, plus ``--device`` (default the card;
``cpu`` runs the plain PyTorch ops) and ``--layers N`` (the arch cut to its
first N layers, widths kept). The schedule (``peak_lr`` 1e-3, 20 warmup
steps, the cosine over ``--steps``), the data (``TokenStream`` of seed 0,
shard 0 of 1), the checkpointer (the last 2 kept), the straggler monitor
(threshold 3) and the printed lines are the reference's. Its mesh of
(devices, 1) is one device here: the sharded launcher waits for the
port's ``sharding/``. The initial weights are ``model.init(0)`` on the
device (``torch.Generator`` draws: not the JAX package's).

``main`` returns a ``TrainRun``: the final ``(params, AdamWState)`` and
where the run ended, every step's loss and wall time, and the loop's
metrics, for a caller to use (the tests, ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import TokenStream
from ..device import resolve_device
from ..models import ModelConfig
from ..optim import adamw_init
from ..runtime import FaultTolerantLoop, LoopMetrics, StragglerMonitor
from .steps import make_train_step


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
    return ap


def main(argv: Optional[list] = None, *,
         inject_failure: Optional[Callable[[int], bool]] = None,
         preempt_at: Optional[int] = None) -> TrainRun:
    """Train per ``argv`` (default: the command line). For callers that
    drive the fault path: ``inject_failure(step)`` is the loop's test hook
    (a step it returns True for raises, and the loop restores and
    replays), and ``preempt_at`` requests a preemption once that many
    steps are done (the loop checkpoints at that boundary and returns)."""
    args = build_parser().parse_args(argv)
    if args.layers is not None and args.layers < 1:
        raise SystemExit("--layers must be >= 1")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model, train_step = make_train_step(cfg, lr_cfg={
        "peak_lr": 1e-3, "warmup": 20, "total": args.steps})

    params = model.init(0, device=device)
    opt = adamw_init(params)
    stream = TokenStream(seed=0, shard=0, n_shards=1,
                         batch_per_shard=args.batch, seq=args.seq,
                         vocab=cfg.vocab_size, device=device)

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = train_step(params, opt, batch)
        return (params, opt), {"loss": float(metrics["loss"])}

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    mon = StragglerMonitor(threshold=3.0)
    loop = FaultTolerantLoop(step_fn, lambda s: stream.batch(s), ckpt,
                             ckpt_every=args.ckpt_every, straggler=mon)
    state = (params, opt)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
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
    return TrainRun(state=state, start=start, end=end, losses=losses,
                    step_seconds=seconds, metrics=loop.metrics, cfg=cfg,
                    model=model)


if __name__ == "__main__":
    main()
