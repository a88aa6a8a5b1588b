"""Fault tolerance: retry-with-restore, preemption, straggler detection —
port of ``repro.runtime.fault_tolerance``.

The loop assumes:

  * the step function is pure (state, batch) → (state, metrics), so any
    step can be replayed from the last checkpoint (the port's
    ``launch.steps`` train step returns new tensors and never writes its
    inputs);
  * the data is a pure function of (seed, step, shard)
    (``repro_torch.data.token_batch``), so a replayed step reads the same
    batch;
  * checkpoints are atomic (``repro_torch.checkpoint``).

Mechanisms:

  * **retry-with-restore** — a failing step (an exception, or a non-finite
    loss under ``abort_on_nan``) restores the latest checkpoint and replays
    from it; at most ``max_retries_per_step`` retries in a row;
  * **preemption** — SIGTERM (with ``install_sigterm``) or
    ``request_preemption()`` sets a flag; the loop saves a blocking
    checkpoint at the next step boundary and returns;
  * **stragglers** — ``StragglerMonitor`` keeps an EMA of per-step wall
    time; a step slower than ``threshold ×`` it is counted (and handed to
    ``on_straggler``). The first ``warmup_steps`` steps are not judged,
    and a slow step moves the EMA by at most ``threshold ×`` it.

Over a mesh (``group``, the ranks that run one sharded step together) a
retry is taken by every rank at the same step: the injected-failure hook
and the preemption flag are OR-ed over the group at each step boundary
(one small ``all_reduce``), a non-finite loss is the mesh's loss (the same
on every rank), and the checkpointer is a ``MeshCheckpointer`` whose
``latest_step`` every rank sees alike. An exception raised inside a
rank's step is not retried there: the other ranks may be waiting for it
in a collective, so it propagates, the rank exits non-zero, and the
launcher ends every rank (``launch.train``, as ``launch.serve``'s).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import numpy as np


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ema_decay: float = 0.9,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.ema_decay = ema_decay
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.events: list[tuple[int, float, float]] = []
        self._seen = 0
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        """Record one step of ``dt`` seconds; True if it straggled."""
        self._seen += 1
        if self._seen <= self.warmup:
            return False
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.threshold * self.ema
        if is_straggler:
            self.events.append((step, dt, self.ema))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
        # slow steps don't poison the EMA
        self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * min(
            dt, self.threshold * self.ema)
        return is_straggler


@dataclasses.dataclass
class LoopMetrics:
    steps_run: int = 0
    retries: int = 0
    restores: int = 0
    preempted: bool = False
    straggler_events: int = 0
    last_loss: float = float("nan")


class FaultTolerantLoop:
    def __init__(
        self,
        step_fn: Callable[[Any, Any], tuple],   # (state, batch) → (state, metrics)
        data_fn: Callable[[int], Any],          # step → batch
        checkpointer,
        *,
        ckpt_every: int = 50,
        max_retries_per_step: int = 2,
        abort_on_nan: bool = True,
        install_sigterm: bool = False,
        straggler: Optional[StragglerMonitor] = None,
        group=None,
    ):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries_per_step
        self.abort_on_nan = abort_on_nan
        self.straggler = straggler or StragglerMonitor()
        self.metrics = LoopMetrics()
        self.group = group
        self._preempt = False
        if install_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, *_):
        self._preempt = True

    def request_preemption(self):
        """Testable preemption entry point (same path as SIGTERM)."""
        self._preempt = True

    def _agree(self, flag: bool) -> bool:
        """``flag`` OR-ed over the group (itself without one)."""
        if self.group is None:
            return bool(flag)
        import torch
        import torch.distributed as dist

        from ..sharding.collectives import any_true

        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(self.group) == "nccl"
               else torch.device("cpu"))
        return bool(any_true(torch.tensor([bool(flag)], device=dev),
                             self.group)[0])

    def run(self, state: Any, start_step: int, num_steps: int,
            inject_failure: Optional[Callable[[int], bool]] = None):
        """Run [start_step, start_step + num_steps); returns (state, the
        step it stopped at). ``inject_failure(step)`` is a test hook that
        raises inside the step when it returns True."""
        step = start_step
        end = start_step + num_steps
        retries_here = 0
        while step < end:
            self._preempt = self._agree(self._preempt)
            if self._preempt:
                self.ckpt.save(step, state, blocking=True)
                self.metrics.preempted = True
                return state, step
            t0 = time.monotonic()
            failing = self._agree(inject_failure is not None
                                  and inject_failure(step))
            in_step = False
            try:
                if failing:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = self.data_fn(step)
                in_step = True
                state, m = self.step_fn(state, batch)
                in_step = False
                loss = (float(m.get("loss", np.nan)) if isinstance(m, dict)
                        else float(m))
                if self.abort_on_nan and not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                self.metrics.last_loss = loss
            except Exception:
                if in_step and self.group is not None:
                    raise          # the other ranks cannot follow a retry
                retries_here += 1
                self.metrics.retries += 1
                if retries_here > self.max_retries:
                    raise
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, restored_step = self.ckpt.restore(state)
                    step = restored_step
                    self.metrics.restores += 1
                continue
            if self.straggler.observe(step, time.monotonic() - t0):
                self.metrics.straggler_events += 1
            retries_here = 0
            step += 1
            self.metrics.steps_run += 1
            if step % self.ckpt_every == 0 and step < end:
                self.ckpt.save(step, state)
        # the last step's checkpoint is this blocking save alone (the
        # reference writes it twice: the periodic save, then this one)
        self.ckpt.save(end, state, blocking=True)
        return state, end
