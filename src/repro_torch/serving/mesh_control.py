"""The async front-end over a mesh: rank 0 leads, every other rank follows.

Rank 0 runs ``AsyncServer`` / ``AsyncClient`` / ``run_open_loop`` over its
engine exactly as on one device. A ``Leader`` attached to that engine
(``engine.control``) records, in order, the calls that change what the
engine will do — each ``submit`` that the engine accepted (a ``QueueFull``
or ``RequestTooLarge`` is not replayed), ``request_drain`` (SIGTERM's
included) and ``cancel`` — and, at the start of each ``step`` (idle steps
included), sends the calls since the last step and the step itself to the
other ranks. Each of them runs ``follow``: it receives the batch, makes the
same calls on its own engine, then steps, so every rank's engine runs the
same forwards (and so the same collectives) at the same ticks. The
front-end's clock is ``engine.clock``, so nothing here reads a wall clock.

The batches go over a gloo process group of their own (``control_group``,
on the host): never over the mesh's NCCL groups, never inside a captured
CUDA graph. Its timeout bounds every receive, so a follower whose leader
died or hung raises instead of waiting forever; a leader that fails sends
an abort, which the followers raise. At the end the leader sends a stop,
and every follower hands back its results, which the leader checks equal
to its own (each rank's engine decided alike).
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as dist

#: seconds a rank waits for a batch (or the others for a collective of
#: the control group) before it raises
CONTROL_TIMEOUT = 600.0


def control_group(timeout: float = CONTROL_TIMEOUT):
    """A gloo group over every rank of the default process group, for the
    control stream. Every rank must call it, in the same order."""
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout))


def _summary(engine) -> dict:
    """What every rank's engine must have decided alike: each result's
    tokens, admission and finish ticks and status."""
    return {rid: (list(r.tokens), r.admitted_at, r.finished_at, r.status)
            for rid, r in engine.results.items()}


class Leader:
    """Rank 0's side: attached to ``engine`` as its ``control``, it batches
    the engine's accepted calls and sends them at each step. ``close``
    sends the stop (or, after a failure, the abort) and, on a stop, checks
    the followers' results against this engine's."""

    def __init__(self, engine, group):
        self.engine = engine
        self.group = group
        self.batches = 0
        self._pending: list = []
        engine.control = self

    def __call__(self, call: str, *args) -> None:
        self._pending.append((call, args))
        if call == "step":
            self._send()

    def _send(self) -> None:
        batch, self._pending = self._pending, []
        dist.broadcast_object_list([batch], src=0, group=self.group)
        self.batches += 1

    def close(self, error: Optional[BaseException] = None) -> None:
        self.engine.control = None
        if error is not None:
            # best effort: the failure may be the control group's own
            self._pending = [("abort", (f"{type(error).__name__}: {error}",))]
            try:
                self._send()
            except Exception:
                pass
            return
        self._pending.append(("stop", ()))
        self._send()
        got = [None] * dist.get_world_size(self.group)
        dist.gather_object(_summary(self.engine), got, dst=0,
                           group=self.group)
        mine = got[0]
        for rank, theirs in enumerate(got[1:], start=1):
            if theirs != mine:
                bad = sorted(r for r in set(mine) | set(theirs)
                             if mine.get(r) != theirs.get(r))
                raise RuntimeError(
                    f"mesh rank {rank} diverged from rank 0 on requests "
                    f"{bad}")


def follow(engine, group) -> int:
    """A follower rank: replay rank 0's calls on ``engine`` batch by batch
    until the stop; returns the steps it took. Raises on an abort, and
    where a replayed call fails (the ranks would have diverged)."""
    steps = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group)
        for call, args in box[0]:
            if call == "abort":
                raise RuntimeError(f"mesh rank 0 failed: {args[0]}")
            if call == "stop":
                dist.gather_object(_summary(engine), None, dst=0,
                                   group=group)
                return steps
            getattr(engine, call)(*args)
            steps += call == "step"
