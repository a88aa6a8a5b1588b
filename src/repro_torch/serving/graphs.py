"""CUDA graphs of the serving engine's fast path, on the card.

The JAX engine compiles each fast-path dispatch once (``jax.jit`` of the
batched prefill and of a ``lax.scan`` a decode horizon) and replays it with
the cache donated. Here each ``(dispatch, shape)`` of the engine's
``warmup_shapes()`` is one ``torch.cuda.CUDAGraph``, captured from the same
eager code the CPU runs — the batched prefill at ``[num_slots, C]``, and a
decode horizon with its K steps unrolled — and replayed: one replay and
one host sync a horizon, against ~1,000 kernel launches a decode step of
the eager path.

What a graph relies on, and how this module keeps it:

  * **Addresses.** A graph reads and writes the tensors it captured: the
    pool's cache leaves (never rebound: the engine copies bookkeeping into
    them, ``warmup`` restores them by ``copy_``), the engine's prepared
    params, and this module's static inputs, into which ``replay`` stages
    the host's arrays (through pinned twins, copied on the graph's stream)
    before each replay. Its outputs are static tensors the engine reads
    once, right after the replay.
  * **Paged pools.** A paged dispatch is one graph holding the gather of
    the page pool into the engine's dense view, the forward on the view,
    and the commit of the written window back into the pages; it reads the
    page table at replay. Admission's page-table row and bookkeeping seed,
    and the copy-on-write page copies, are eager in-place writes on the
    caller's stream, which every replay waits for.
  * **No host work inside.** The impls read nothing back to the host; what
    the host decides while capturing (the decode route, the GEMM and
    attention plans) is frozen into the graph, which belongs to its engine.
  * **Lazy device state before capture.** Before each capture, the same
    dispatch with every row masked runs eagerly on the capture stream: it
    builds the kernels, sets their attributes, brings up cuBLAS on that
    stream and allocates the stream's zero scratch (``dispatch.
    stream_scratch``) outside the graph's memory. By the engine's
    ride-along rules the masked dispatch leaves bookkeeping and live K/V as
    they were.
  * **One stream.** Masked dispatches, captures and replays all run on
    this object's stream, in order, so a replay never overlaps another
    launch on the scratch the graph captured, and the graphs can share one
    memory pool. The stream waits for the caller's stream before each
    replay (the pool's eager resets) and the caller's stream waits for it
    after.
  * **Launch counts.** ``dispatch.count_launch`` is a host counter: the
    capture's count is taken back (nothing ran) and added again at every
    replay, so ``launch_counts()`` keeps counting the launches that ran.

A capture that fails raises; nothing falls back to running the fast path
eagerly on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..kernels.dispatch import add_launches, launch_counts


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple             # static device tensors the host stages into
    host: tuple               # their pinned host twins
    staged: "torch.cuda.Event"  # the last staging copy out of ``host``
    outputs: tuple            # static device tensors each replay writes
    launches: Dict[str, int]  # kernel launches one replay makes


class EngineGraphs:
    """The captured graphs of one engine, keyed by ``(dispatch, dim)``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[Tuple[str, int], _Graph] = {}
        self.capture_seconds = 0.0
        # device memory reserved while capturing: the graphs' shared pool
        self.pool_bytes = 0

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def launches(self, key) -> Dict[str, int]:
        """{kernel: launches} one replay of ``key`` makes."""
        return dict(self._graphs[key].launches)

    def capture(self, key, fn: Callable, args: tuple,
                warm: Callable[[], None]) -> None:
        """Capture ``fn`` on static copies of the numpy ``args``, after
        ``warm()`` (the masked dispatch) ran eagerly on the capture stream."""
        t0 = time.perf_counter()
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            warm()
            inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for a in args)
        # the capture below empties the allocator's cache first: do it here,
        # so that what it reserves is the graph's alone
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            outputs = fn(*inputs)
        counted = {op: n - before.get(op, 0)
                   for op, n in launch_counts().items()
                   if n != before.get(op, 0)}
        add_launches({op: -n for op, n in counted.items()})
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in inputs)
        self._graphs[key] = _Graph(graph, inputs, host, torch.cuda.Event(),
                                   tuple(outputs), counted)
        caller.wait_stream(self.stream)
        self.capture_seconds += time.perf_counter() - t0

    def replay(self, key, args: tuple) -> tuple:
        """Stage the numpy ``args`` into ``key``'s static inputs, replay
        it, and return its static outputs (valid until the next replay)."""
        g = self._graphs[key]
        g.staged.synchronize()       # the last copy out of g.host is done
        for host, a in zip(g.host, args):
            host.numpy()[...] = a
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            for static, host in zip(g.inputs, g.host):
                static.copy_(host, non_blocking=True)
            g.staged.record(self.stream)
            g.graph.replay()
        caller.wait_stream(self.stream)
        add_launches(g.launches)
        return g.outputs
