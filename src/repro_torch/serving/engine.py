"""Continuous-batching serving engine over a contiguous or paged KV pool, int8
or fp (port of ``repro.serving.engine.ServingEngine``).

One engine step runs four phases over the slot-based KV-cache pool:

  0. **reap** — in-flight requests that were cancelled or whose deadline
     passed retire with the tokens they have (status "cancelled" /
     "expired"); their slot and pages come back at once.
  1. **admit** — while a slot is free and the FIFO head has arrived, claim
     the lowest free slot (bookkeeping reset only; stale K/V is masked).
     Preempted (parked) requests resume first; cancelled or expired queue
     heads are shed here, at the tick a slot would have taken them.
  2. **chunked prefill** — every admitted-but-unfinished request advances by
     one fixed-size prompt chunk. Each dispatch is a full-width masked
     prefill in slot position: the rows that are not prefilling ride along,
     their bookkeeping rolls back and their written ring window is
     restored, so a decoding slot riding along is untouched. The final
     chunk is zero-padded; pad writes are invalidated (kpos → -1) and the
     first generated token is read from the last valid position's logits.
  3. **batched decode** — decode steps over the full slot batch with
     per-slot positions; rows that are not decoding ride along and their
     bookkeeping write is rolled back. Finished requests retire and their
     slots are reusable at once.

Two executions of that loop share the bookkeeping above:

  * the **fast path** (default): all prefilling slots advance in ONE
    ``[num_slots, C]`` dispatch, the slot reset of an admission is folded
    into its first chunk (a ``fresh`` row mask), and decode runs K steps in
    one dispatch that returns a ``[B, K]`` token buffer — one host sync a
    horizon. The host picks K adaptively (``min(decode_horizon, smallest
    remaining budget, next scheduled arrival - clock, earliest deadline -
    clock)``, rounded down to a power of two; 1 while any prefill is in
    flight), so retirement, admission, expiry and prefill land on exactly
    the stepwise path's ticks. On the card each ``(dispatch, shape)`` of
    ``warmup_shapes()`` is a CUDA graph (``graphs.py``) captured from the
    same code the CPU runs eagerly, at its first dispatch or at
    ``warmup()``: the batched prefill, and one graph a power-of-two
    horizon with its K steps unrolled.
  * the **stepwise reference** (``fast=False``): one full-width dispatch a
    prefill chunk, one decode step an engine step, one host sync each —
    kept as the parity oracle.

Every row's computation is independent of the others (masked keys
contribute exact zeros), so a request's tokens do not depend on what else
is in the batch, nor on the path, nor on the layout.

**Paged** (``page_size=...``): the pool keeps K/V in refcounted pages with a
per-slot page table (``cache_pool.py``). Each dispatch gathers every slot's
pages into a dense ``[L, B, S, ...]`` view that the engine holds (outside
``pool.cache``, so the pool's byte count stays the JAX pool's), runs the
same contiguous impl on it, and writes back only the ring positions the
dispatch wrote (``_paged_view`` / ``_paged_commit``); on the card the
gather, the forward and the commit are one graph, which reads the page
table at replay. Admission maps shared prefix pages from the scheduler's
``PrefixIndex`` — the reuse length aligned down to a prefill-chunk
boundary, which makes the donor's K/V bit-identical to recomputing them —
and prefill completion publishes the request's fully covered prompt pages.

**Fault tolerance**: requests carry an optional ``deadline`` and a
``priority``; ``cancel`` and deadlines act at step boundaries. When paged
admission runs out of pages it climbs a ladder — evict LRU prefix-index
entries, preempt strictly-lower-priority requests (their computed pages
published first, the request parked on the host with what it generated),
then block head-of-line. A row whose logits are non-finite (or that
``inject_bad`` marked) is quarantined at its next host sync.
``request_drain`` closes admission and finishes what was admitted.
``serving/chaos.py`` drives all of it deterministically.

**Tensor-parallel** (``mesh=``, a ``torch.distributed`` ``DeviceMesh``
from ``launch.mesh``): the params are placed by the reference's planner
(``sharding.partition``, serve mode) and each rank keeps its blocks; the
pool holds the rank's slots ("data", contiguous only) and KV heads
("model"); the forward runs under ``sharding.tp`` (column- and
row-parallel projections, head-local attention where the model axis
divides both head counts, the vocab-parallel embedding and logits) and
each dispatch's per-slot outputs are gathered over the data axis; an MoE
block routes and dispatches this rank's slots, its experts column- and
row-parallel over "model" (``sharding.tp``). Every
rank runs this same host loop: it reads only the requests and the tokens,
which every rank receives whole from the collectives, so the ranks decide
the same admissions, chunks, horizons and preemptions — no decision reads
a rank's wall clock. Under NCCL the fast path's graphs capture the
collectives; gloo's block the host, and a gloo engine runs the fast path
eagerly (``stats["graphs"]`` 0, ``stats["graphs_off"]`` says why).

Unlike the JAX engine, which donates the cache to each jitted step, the
port updates ``pool.cache`` IN PLACE and never rebinds a leaf: the model
writes the K/V payload into the pool's own tensors (paged: into the dense
view, then the commit into the pages), and the engine copies the ``kpos`` /
``pos`` bookkeeping into them. A captured graph holds those addresses.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.dispatch import TIERS, tier_scope
from ..runtime.fault_tolerance import StragglerMonitor
from ..sharding.tp import tp_scope
from .cache_pool import KNOWN_BOOKKEEPING, CachePool
from .errors import QueueFull, RequestTooLarge
from .scheduler import FIFOScheduler, PrefixIndex, Request


def required_cache_len(prompt_len: int, max_new_tokens: int,
                       prefill_chunk: int) -> int:
    """Ring positions a request needs: the zero-padded prefill chunks and
    the full decoded context."""
    padded = -(-prompt_len // prefill_chunk) * prefill_chunk
    return max(padded, prompt_len + max_new_tokens - 1)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _take_window(leaf, win):
    """Ring positions ``win`` [B, C] of a payload leaf [L, B, S, ...] →
    [L, B, C, ...] (a copy)."""
    row = torch.arange(leaf.shape[1], device=leaf.device)[:, None]
    return leaf[:, row, win]


def _put_window(leaf, win, vals):
    """Write ``vals`` [L, B, C, ...] into ring positions ``win`` [B, C] of a
    payload leaf [L, B, S, ...], in place."""
    row = torch.arange(leaf.shape[1], device=leaf.device)[:, None]
    leaf[:, row, win] = vals.to(leaf.dtype)


def _flat(t):
    """A leaf [L, X, Y, ...] viewed as [L, X*Y, ...] (no copy)."""
    return t.view((t.shape[0], -1) + tuple(t.shape[3:]))


def _paged_view(pool: CachePool, dense: dict) -> None:
    """Gather every slot's mapped pages into ``dense`` ({leaf: [L, B, S,
    ...]}), in place, one ``index_select`` a leaf. Unmapped table entries
    (-1) read page 0: finite garbage at positions the bookkeeping marks
    dead (``kpos = -1``), the same invariant that makes recycled contiguous
    slots exact."""
    pg, S = pool.page_size, pool.max_len
    ring = torch.arange(S, device=pool.cache["kpos"].device)
    table = pool.cache["page_table"].clamp(min=0)             # [B, S/pg]
    idx = (table[:, ring // pg] * pg + ring % pg).reshape(-1)  # [B*S]
    for name, store in pool.storage.items():
        torch.index_select(_flat(store), 1, idx, out=_flat(dense[name]))


def _paged_commit(pool: CachePool, dense: dict, rows) -> None:
    """Write the ring positions a dispatch wrote (``rows`` [B, W], -1 for
    none) from ``dense`` back into their pages. A position whose page is
    unmapped, and every -1, goes to the pool's sink page, which no table
    entry maps (PyTorch has no scatter that drops). Pages shared between
    slots are never in a write window (admission copies the one boundary
    page), so every other index is unique and the writes deterministic."""
    pg, S = pool.page_size, pool.max_len
    B = rows.shape[0]
    idx = rows.clamp(min=0)
    page = torch.gather(pool.cache["page_table"], 1, idx // pg)   # [B, W]
    dst = torch.where((rows >= 0) & (page >= 0), page * pg + idx % pg,
                      pool.sink_page * pg).reshape(-1)
    src = (torch.arange(B, device=rows.device)[:, None] * S
           + idx).reshape(-1)
    for name, store in pool.storage.items():
        vals = _flat(dense[name]).index_select(1, src)
        _flat(store).index_copy_(1, dst, vals)


@dataclasses.dataclass
class _InFlight:
    req: Request
    slot: int
    admitted_at: float
    prefilled: int = 0
    generated: list = dataclasses.field(default_factory=list)
    cur_token: int = 0
    # fast path: slot bookkeeping reset deferred to the first prefill chunk
    fresh: bool = False
    # a resumed request runs as an internal Request whose prompt is the
    # original prompt + the tokens generated before its preemption:
    # ``prior`` holds those tokens and ``orig_req`` the original request,
    # so retirement merges them into ONE result under the original rid
    prior: list = dataclasses.field(default_factory=list)
    orig_req: Optional[Request] = None

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= len(self.req.prompt)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new_tokens

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.generated)


@dataclasses.dataclass
class _Parked:
    """A preempted request waiting on the host: the ORIGINAL request and
    everything generated before the preemption. It resumes through normal
    admission as an internal request whose prompt is ``req.prompt +
    generated``; the prefix index remaps whatever published pages survived
    and the rest is prefilled again (bit-identical either way)."""

    req: Request
    generated: list
    admitted_at: float


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: list  # generated token ids
    arrival: float
    admitted_at: float
    finished_at: float
    # "ok" | "expired" | "cancelled" | "quarantined" — a result that is not
    # ok carries the tokens generated before the fault (possibly none)
    status: str = "ok"


class ServingEngine:
    """Serve requests against one model + params with continuous batching.

    num_slots: decode batch width (cache pool size). max_len: per-slot ring
    capacity; a request needs max(ceil(P/chunk)*chunk, P + G - 1) <= max_len.
    prefill_chunk: prompt-chunk length. decode_horizon: most decode steps in
    one dispatch of the fast path; each power of two up to it is one shape
    (one CUDA graph on the card). fast: the fast path (default);
    ``fast=False`` is the stepwise reference, the same tokens and ticks
    with one host sync a token. kv_bits: 8 (the int8 cache) or 16 (the fp
    cache); None follows ``cfg.kv_cache_bits`` (so a ``*-kv8`` recipe's
    model gets the int8 cache). page_size: the paged layout (see the
    module docstring); the same tokens as the contiguous pool. num_pages:
    the page-pool size (default: a full ring for every slot); admission
    blocks head-of-line when the pool cannot cover the head, after the
    ladder. prefix_reuse: the ``PrefixIndex`` (paged only). backend: the
    kernel tier every op of the engine's forwards resolves at (``cuda`` |
    ``torch``; None: the registry's rule, ``REPRO_KERNEL_BACKEND`` then the
    device). max_queue: bound on the admission queue (``submit`` beyond it
    raises the retryable ``QueueFull``). straggler: a ``StragglerMonitor``
    observing each engine step's wall time (``stats["straggler_steps"]``);
    None = defaults. device: where the pool lives and the params must
    live; the card unless ``device="cpu"``. mesh: a ``DeviceMesh``
    ("data", "model" [, leading "pod"]) to serve tensor-parallel over
    (see the module docstring); every rank of it builds its engine from
    the same params and serves the same requests.

    **Streaming** (``set_stream_callbacks``): ``on_token(rid, tokens,
    tick)`` fires at every host sync that brings new tokens of a request
    (token ``i`` landed at tick ``tick + i``; a horizon delivers its K
    tokens in one call), ``on_result(result)`` once a request, when its
    result is recorded, for every terminal status — requests shed from the
    queue or reaped while parked included. A preempted request streams
    each token once.

    A captured graph belongs to this engine and freezes what the host
    decided while it was captured: the ``REPRO_FUSED_DECODE`` route, the
    GEMM and attention plans, the prepared (compute-dtype) params. An
    engine built after the environment changed captures its own graphs, so
    changing the route between engines is safe; changing it under a live
    engine does not reroute its graphs.
    """

    def __init__(self, model, params, cfg, *, num_slots: int = 4,
                 max_len: int = 128, prefill_chunk: int = 16,
                 decode_horizon: int = 8, fast: bool = True,
                 kv_bits: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None, prefix_reuse: bool = True,
                 max_queue: Optional[int] = None,
                 straggler: Optional[StragglerMonitor] = None,
                 device="cuda", backend: Optional[str] = None, mesh=None):
        if cfg.family in ("ssm", "hybrid", "audio"):
            raise ValueError(
                f"the serving engine supports attention-family decoder-only "
                f"models (got {cfg.name!r}, family {cfg.family!r})")
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got {decode_horizon}")
        self.device = resolve_device(device)
        if backend is not None and backend not in TIERS:
            raise ValueError(f"unknown kernel tier {backend!r}; tiers are "
                             f"{', '.join(TIERS)}")
        self.backend = backend
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine serves on {self.device}")
        self.model = model
        self.mesh = mesh
        self.shard = None
        if mesh is not None:
            import torch.distributed as dist

            from ..sharding.partition import shard_tree
            from ..sharding.tp import ServeShard

            self.shard = ServeShard(
                mesh, cfg, params, num_slots=num_slots,
                paged=page_size is not None,
                backend=dist.get_backend(mesh.get_group("model")))
            # this rank's blocks of the serve-mode specs
            params = shard_tree(params, self.shard.specs, mesh)
        self.params = params
        # the compute-dtype cast, out of the loop; held so that the tensors
        # a captured graph reads outlive any later prepare of other params
        self._prepared = model.prepare(params)
        self.cfg = cfg
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.decode_horizon = decode_horizon
        self.fast = fast
        self.pool = CachePool(model, num_slots, max_len, device=self.device,
                              kv_bits=kv_bits, page_size=page_size,
                              num_pages=num_pages, shard=self.shard)
        self.kv_bits = self.pool.kv_bits
        self.page_size = self.pool.page_size
        self.paged = self.pool.paged
        self.prefix_index = (PrefixIndex(self.page_size)
                             if self.paged and prefix_reuse else None)
        self.max_len = self.pool.max_len
        if self.paged:
            # the dense view the dispatches run on: [L, B, S, ...] a payload
            # leaf, with the pool's own kpos / pos
            self.dense = {name: torch.zeros(
                (store.shape[0], num_slots, self.max_len)
                + tuple(store.shape[3:]), dtype=store.dtype,
                device=self.device) for name, store in self.pool.storage.items()}
            self._view = {**self.dense, "kpos": self.pool.cache["kpos"],
                          "pos": self.pool.cache["pos"]}
        self.scheduler = FIFOScheduler(max_queue=max_queue)
        self.straggler = straggler or StragglerMonitor()
        self.graphs = None
        if not fast:
            graphs_off = "the stepwise path"
        elif self.device.type != "cuda":
            graphs_off = "the CPU runs the fast path eagerly"
        elif self.shard is not None and self.shard.backend != "nccl":
            graphs_off = (f"{self.shard.backend}'s collectives block the "
                          f"host: no CUDA graph can capture them")
        else:
            from .graphs import EngineGraphs

            graphs_off = ""
            self.graphs = EngineGraphs(self.device)
        # forwards of the masked dispatches run before each capture (they
        # are in no stat: warmup reports them)
        self._masked_forwards = {"decode_steps": 0, "prefill_dispatches": 0}
        self.clock = 0.0
        # streaming surface (set_stream_callbacks)
        self._on_token = None
        self._on_result = None
        self._inflight: dict[int, _InFlight] = {}
        self._parked: collections.deque[_Parked] = collections.deque()
        # rids to cancel at the next step boundary, and rids whose row is
        # treated as non-finite at its next host sync (chaos)
        self._cancelled: set[int] = set()
        self._inject_bad: set[int] = set()
        self._draining = False
        # the listener of the accepted submit / cancel / request_drain
        # calls and of each step (``_tell``): a mesh's async leader
        self.control = None
        # REPRO_POOL_CHECK=1: audit the pool's bookkeeping after every step
        self._pool_check = os.environ.get("REPRO_POOL_CHECK") == "1"
        self.results: dict[int, RequestResult] = {}
        self.stats = {
            "decode_steps": 0,        # token-level steps (fast: += K a horizon)
            "decode_dispatches": 0,   # model decode dispatches
            "prefill_chunks": 0,      # chunk-level prefill advances
            "prefill_dispatches": 0,  # model prefill dispatches
            "host_syncs": 0,          # device → host reads
            "generated_tokens": 0,
            "occupancy_sum": 0.0,     # Σ per-tick slot occupancy
            "engine_steps": 0,        # engine-clock ticks
            "preempted": 0,           # in-flight requests parked for pages
            "resumed": 0,             # parked requests admitted again
            "shed": 0,                # submissions rejected (QueueFull)
            "cancelled": 0,           # cancellations honored
            "expired": 0,             # deadline reaps (queued or in flight)
            "quarantined": 0,         # non-finite rows retired
            "straggler_steps": 0,     # engine steps flagged by the monitor
            # what "slow" means for the monitor (a config echo)
            "straggler_threshold": float(getattr(self.straggler,
                                                 "threshold", 0.0)),
            # whether the fast path replays CUDA graphs, and why not
            "graphs": int(self.graphs is not None),
            "graphs_off": graphs_off,
        }

    @classmethod
    def from_quantized(cls, qm, **kwargs) -> "ServingEngine":
        """Build an engine over a pipeline ``QuantizedModel``."""
        return cls(qm.model, qm.params, qm.cfg, **kwargs)

    # ------------------------------------------------------- device steps
    def _prefill_masked(self, cache, tokens, n_valid, fresh, is_real):
        """Full-width masked prefill over ``cache`` (the pool's, or the
        paged dense view): every slot advances one chunk in slot position.
        tokens [B, C] (zero rows for slots not prefilling); n_valid [B] (1
        for pad rows: they select position 0's logits); fresh [B] rows
        whose bookkeeping reset (kpos → -1, pos → 0) was deferred from
        ``CachePool.allocate(reset=False)``; is_real [B]. Pad rows run for
        shape stability; their bookkeeping rolls back and their C-wide ring
        window — saved before the model's in-place appends — is restored,
        so their cache bytes are unchanged. Returns per-row greedy tokens
        from each row's last valid position and the non-finite flag of the
        real rows. Reads no tensor back to the host.
        """
        C = tokens.shape[1]
        S = cache["kpos"].shape[1]
        start = torch.where(fresh, 0, cache["pos"])                  # [B]
        win = (start[:, None]
               + torch.arange(C, device=start.device)[None, :]) % S   # [B, C]
        payload = [k for k in cache if k not in KNOWN_BOOKKEEPING]
        saved = {k: _take_window(cache[k], win) for k in payload}
        sub = {**cache, "kpos": torch.where(fresh[:, None], -1, cache["kpos"]),
               "pos": start}
        logits, sub = self.model.prefill(self.params, tokens, sub,
                                         logits_at=n_valid - 1)
        tok, nonfinite = self._pick(logits)
        end = start + n_valid
        kpos = torch.where(sub["kpos"] >= end[:, None], -1, sub["kpos"])
        for k in payload:
            keep = is_real.reshape((1, -1) + (1,) * (saved[k].ndim - 2))
            _put_window(cache[k], win,
                        torch.where(keep, _take_window(cache[k], win), saved[k]))
        kpos = torch.where(is_real[:, None], kpos, cache["kpos"])
        pos = torch.where(is_real, end, cache["pos"])
        cache["kpos"].copy_(kpos)
        cache["pos"].copy_(pos)
        return tok, nonfinite & is_real

    def _decode_masked(self, cache, tokens, active):
        """One full-slot-batch decode step over ``cache``. Rows not in
        ``active`` ride along; their bookkeeping write (one kpos entry, the
        pos advance) is rolled back — their K/V payload write is masked by
        kpos = -1 and overwritten by the slot's next real token at the same
        ring index."""
        prev_pos = cache["pos"]
        logits, new = self.model.decode_step(self.params, tokens, cache)
        S = cache["kpos"].shape[1]
        wrote = (torch.arange(S, device=prev_pos.device)[None, :]
                 == (prev_pos % S)[:, None])
        kpos = torch.where((~active)[:, None] & wrote, -1, new["kpos"])
        pos = torch.where(active, new["pos"], prev_pos)
        cache["kpos"].copy_(kpos)
        cache["pos"].copy_(pos)
        tok, nonfinite = self._pick(logits)
        return tok, nonfinite & active

    def _pick(self, logits):
        """(greedy token, non-finite flag) of each row; over the vocab
        shards of a sharded engine."""
        if self.shard is not None:
            return self.shard.pick(logits)
        return torch.argmax(logits, dim=-1), ~torch.isfinite(logits).all(dim=-1)

    def _on_slots(self, impl, *args, **kwargs):
        """``impl`` over the contiguous pool on this rank's slots: the
        per-slot arguments cut to its rows, each output gathered over the
        data-parallel group, so every rank's host sees every slot."""
        sh = self.shard
        if sh is None or not sh.slots_sharded:
            return impl(self.pool.cache, *args, **kwargs)
        lo, hi = sh.slot_lo, sh.slot_hi
        out = impl(self.pool.cache, *(a[lo:hi] for a in args), **kwargs)
        return tuple(sh.gather_slots(o) for o in out)

    def _decode_horizon_impl(self, cache, tokens, remaining, *, k: int):
        """K decode steps over ``cache`` in one dispatch, one host sync.

        tokens [B, 1] the current token a slot (garbage for inactive rows);
        remaining [B] tokens still owed a slot (0 = free or mid-prefill).
        Each step is exactly the stepwise masked decode with ``active =
        remaining > 0``; a row whose budget runs out freezes in place (its
        token stops being fed forward and its bookkeeping rolls back).
        Returns the [B, k] token buffer and the per-row bad flag OR-ed
        across the row's active steps. The steps are unrolled: on the card
        one graph holds all k.
        """
        bad_any = torch.zeros(remaining.shape, dtype=torch.bool,
                              device=remaining.device)
        toks = []
        for _ in range(k):
            active = remaining > 0
            nxt, bad = self._decode_masked(cache, tokens, active)
            tokens = torch.where(active[:, None], nxt[:, None], tokens)
            remaining = torch.where(active, remaining - 1, remaining)
            bad_any = bad_any | bad
            toks.append(nxt)
        return torch.stack(toks, dim=1), bad_any

    # The three dispatches over the engine's cache. Paged, each gathers the
    # page pool into the dense view, runs the contiguous impl on it, and
    # commits the window it wrote — computed from ``pos`` before the impl,
    # on the device, so that a graph holds all three.
    def _ring_rows(self, start, keep):
        """[B, W] ring positions ``start + 0..W-1`` (mod S), -1 where
        ``keep`` [B, W] is False."""
        t = torch.arange(keep.shape[1], device=start.device)[None, :]
        return torch.where(keep, (start[:, None] + t) % self.max_len, -1)

    def _on_view(self, rows, impl, *args, **kwargs):
        """``impl`` over the paged pool: gather, run on the dense view,
        commit ``rows``."""
        _paged_view(self.pool, self.dense)
        out = impl(self._view, *args, **kwargs)
        _paged_commit(self.pool, self.dense, rows)
        return out

    def _prefill(self, tokens, n_valid, fresh, is_real):
        """One full-width masked prefill (``_prefill_masked``); the fast
        path's ``[num_slots, C]`` dispatch."""
        if not self.paged:
            return self._on_slots(self._prefill_masked, tokens, n_valid,
                                  fresh, is_real)
        start = torch.where(fresh, 0, self.pool.cache["pos"])
        rows = self._ring_rows(start, is_real[:, None].expand(tokens.shape))
        return self._on_view(rows, self._prefill_masked, tokens, n_valid,
                             fresh, is_real)

    def _decode(self, tokens, active):
        """One masked decode step (the stepwise path)."""
        if not self.paged:
            return self._on_slots(self._decode_masked, tokens, active)
        rows = self._ring_rows(self.pool.cache["pos"], active[:, None])
        return self._on_view(rows, self._decode_masked, tokens, active)

    def _decode_horizon(self, tokens, remaining, *, k: int):
        """A decode horizon (``_decode_horizon_impl``); paged, ONE gather
        before its k steps and one commit after them."""
        if not self.paged:
            return self._on_slots(self._decode_horizon_impl, tokens,
                                  remaining, k=k)
        t = torch.arange(k, device=remaining.device)[None, :]
        rows = self._ring_rows(self.pool.cache["pos"], t < remaining[:, None])
        return self._on_view(rows, self._decode_horizon_impl, tokens,
                             remaining, k=k)

    def _prefill_chunk_impl(self, chunk: np.ndarray, slot: int, n_valid: int):
        """One prompt chunk [1, C] into ``slot``, as the slot's row of a
        full-width masked prefill (the stepwise path). Returns (token,
        non-finite flag) of the slot's row, still on the device."""
        B, C = self.num_slots, chunk.shape[1]
        tokens = np.zeros((B, C), np.int64)
        tokens[slot] = chunk[0]
        n_vec = np.ones((B,), np.int64)
        n_vec[slot] = n_valid
        is_real = np.arange(B) == slot
        dev = self.device
        tok, bad = self._prefill(torch.from_numpy(tokens).to(dev),
                                 torch.from_numpy(n_vec).to(dev),
                                 torch.zeros((B,), dtype=torch.bool,
                                             device=dev),
                                 torch.from_numpy(is_real).to(dev))
        return tok[slot], bad[slot]

    def _fast_impl(self, name: str, dim: int):
        if name == "prefill_multi":
            return self._prefill
        return functools.partial(self._decode_horizon, k=dim)

    def _masked_args(self, name: str) -> tuple:
        """The dispatch ``name`` with every row masked: pad prefill rows,
        or no decode budget. It leaves bookkeeping and live K/V as they
        were (the ride-along rules above; paged, it commits nothing)."""
        B = self.num_slots
        if name == "prefill_multi":
            return (np.zeros((B, self.prefill_chunk), np.int64),
                    np.ones((B,), np.int64), np.zeros((B,), bool),
                    np.zeros((B,), bool))
        return np.zeros((B, 1), np.int64), np.zeros((B,), np.int64)

    def _run_masked(self, name: str) -> None:
        """One masked dispatch, eagerly on the current stream (the capture
        stream, before a capture): a one-step horizon for every decode
        shape, since each step runs the same kernels."""
        args = tuple(torch.from_numpy(a).to(self.device)
                     for a in self._masked_args(name))
        self._fast_impl(name, 1)(*args)
        self._masked_forwards["decode_steps" if name == "decode_horizon"
                              else "prefill_dispatches"] += 1

    def _dispatch(self, name: str, dim: int, args: tuple):
        """Run the fast path's dispatch ``(name, dim)`` on numpy ``args``;
        returns its outputs on the device. On the CPU the impl runs
        eagerly; on the card its graph is replayed (captured first, at the
        first dispatch of the shape)."""
        fn = self._fast_impl(name, dim)
        if self.graphs is None:
            return fn(*(torch.from_numpy(a).to(self.device) for a in args))
        key = (name, dim)
        if key not in self.graphs:
            self.graphs.capture(key, fn, args,
                                warm=functools.partial(self._run_masked, name))
        return self.graphs.replay(key, args)

    # -------------------------------------------------------- host loop
    def submit(self, request: Request) -> None:
        P, G = len(request.prompt), request.max_new_tokens
        need = required_cache_len(P, G, self.prefill_chunk)
        if need > self.max_len:
            raise RequestTooLarge(
                f"request {request.rid}: needs {need} cache positions "
                f"(prompt {P}, gen {G}, chunk {self.prefill_chunk}) but "
                f"max_len={self.max_len}")
        if self.paged:
            n_pages = -(-need // self.page_size)
            if n_pages > self.pool.num_pages:
                # even an empty pool could never map it
                raise RequestTooLarge(
                    f"request {request.rid}: needs {n_pages} pages "
                    f"(page_size {self.page_size}) but the pool only has "
                    f"{self.pool.num_pages}")
        if self._draining:
            self.stats["shed"] += 1
            raise QueueFull(f"request {request.rid}: engine is draining — "
                            f"admission is closed")
        try:
            self.scheduler.submit(request)
        except QueueFull:
            self.stats["shed"] += 1
            raise
        self._tell("submit", request)

    def _tell(self, call: str, *args) -> None:
        """Hand an accepted call to ``self.control`` (rank 0 of a mesh's
        async front-end: ``serving.mesh_control.Leader``), if any."""
        if self.control is not None:
            self.control(call, *args)

    def set_stream_callbacks(self, on_token=None, on_result=None) -> None:
        """Wire the streaming surface (see the class docstring); None
        detaches either."""
        self._on_token = on_token
        self._on_result = on_result

    def _emit_tokens(self, fl: _InFlight, tokens: Sequence[int],
                     tick: float) -> None:
        if self._on_token is not None:
            # a resumed request keeps its original rid: the stream is
            # continuous across preemption
            self._on_token(fl.req.rid, list(tokens), tick)

    def _emit_result(self, result: RequestResult) -> None:
        if self._on_result is not None:
            self._on_result(result)

    def _drop_result(self, req: Request, status: str,
                     tokens: Sequence[int] = (),
                     admitted_at: Optional[float] = None) -> None:
        """Record the result of a request dropped OUTSIDE a slot (shed from
        the queue, or reaped while parked)."""
        self.results[req.rid] = RequestResult(
            rid=req.rid, prompt_len=len(req.prompt), tokens=list(tokens),
            arrival=req.arrival,
            admitted_at=self.clock if admitted_at is None else admitted_at,
            finished_at=self.clock, status=status)
        self._emit_result(self.results[req.rid])

    def _next_admission(self) -> Optional[Request]:
        """The head of the queue once it has arrived, after shedding
        cancelled and expired heads (at the tick a free slot would have
        admitted them)."""
        while True:
            req = self.scheduler.peek_ready(self.clock)
            if req is None:
                return None
            if req.rid in self._cancelled:
                self.scheduler.drop_head()
                self._cancelled.discard(req.rid)
                self._drop_result(req, "cancelled")
                self.stats["cancelled"] += 1
                continue
            if req.deadline is not None and req.deadline <= self.clock:
                self.scheduler.drop_head()
                self._drop_result(req, "expired")
                self.stats["expired"] += 1
                continue
            return req

    def _next_parked(self) -> Optional[_Parked]:
        """The parked head due for resumption, after reaping cancelled and
        expired parked entries (their partial tokens are returned)."""
        while self._parked:
            parked = self._parked[0]
            req = parked.req
            if req.rid in self._cancelled:
                self._parked.popleft()
                self._cancelled.discard(req.rid)
                self._drop_result(req, "cancelled", tokens=parked.generated,
                                  admitted_at=parked.admitted_at)
                self.stats["cancelled"] += 1
                continue
            if req.deadline is not None and req.deadline <= self.clock:
                self._parked.popleft()
                self._drop_result(req, "expired", tokens=parked.generated,
                                  admitted_at=parked.admitted_at)
                self.stats["expired"] += 1
                continue
            return parked
        return None

    def _resume_request(self, parked: _Parked) -> Request:
        """The internal request a parked entry resumes as: the original
        prompt plus everything generated before the preemption, owing the
        rest of the budget. Prefilling that prompt again reproduces the
        victim's cache exactly (prefill and decode agree on every cached
        position)."""
        req = parked.req
        return Request(
            rid=req.rid,
            prompt=list(req.prompt) + [int(t) for t in parked.generated],
            max_new_tokens=req.max_new_tokens - len(parked.generated),
            arrival=req.arrival, deadline=req.deadline,
            priority=req.priority)

    def _admit(self) -> None:
        """Admission: parked (preempted) requests resume first — they were
        admitted once, so a drain still serves them — then the FIFO queue
        (closed while draining)."""
        if self.paged:
            return self._admit_paged()
        pool = self.pool
        while pool.n_free:
            parked = self._next_parked()
            if parked is not None:
                self._parked.popleft()
                req = self._resume_request(parked)
                # fast path: the slot's bookkeeping reset is deferred into
                # its first prefill chunk, like any fresh admission
                slot = pool.allocate(reset=not self.fast)
                self._inflight[slot] = _InFlight(
                    req=req, slot=slot, admitted_at=parked.admitted_at,
                    fresh=self.fast, prior=list(parked.generated),
                    orig_req=parked.req)
                self.stats["resumed"] += 1
                continue
            if self._draining:
                return
            req = self._next_admission()
            if req is None:
                return
            self.scheduler.pop_ready(self.clock)
            # fast path: the slot's bookkeeping reset is deferred into its
            # first prefill chunk (the fresh mask) — admission dispatches
            # nothing
            slot = pool.allocate(reset=not self.fast)
            self._inflight[slot] = _InFlight(req=req, slot=slot,
                                             admitted_at=self.clock,
                                             fresh=self.fast)

    def _admit_paged(self) -> None:
        """Page-aware FIFO admission: peek the candidate (parked resumes
        first), map its shared prefix pages from the index, and admit only
        when the pool can cover the rest, climbing the ladder first
        (``_cover_pages``). No reset is deferred: ``allocate_pages`` seeds
        the slot's bookkeeping and page-table row in place."""
        pool = self.pool
        while pool.n_free:
            parked = self._next_parked()
            if parked is not None:
                req = self._resume_request(parked)
            else:
                if self._draining:
                    return
                req = self._next_admission()
                if req is None:
                    return
            P, G = len(req.prompt), req.max_new_tokens
            need = required_cache_len(P, G, self.prefill_chunk)
            shared: list = []
            reuse = 0
            if self.prefix_index is not None:
                pages = self.prefix_index.lookup(req.prompt)
                pg, C = self.page_size, self.prefill_chunk
                # reuse ends on a prefill-chunk boundary — the donor's
                # chunks started there too, which makes its cached K/V
                # bit-identical to recomputing them — and leaves >= 1
                # prompt token to prefill, so the first generated token
                # comes from this request's own logits
                reuse = (min(len(pages) * pg, P - 1) // C) * C
                shared = pages[: -(-reuse // pg)]
            fresh_needed = pool.pages_needed(need, reuse)
            if not self._cover_pages(fresh_needed, shared, req.priority):
                return                      # head-of-line blocks on pages
            if parked is not None:
                self._parked.popleft()
            else:
                self.scheduler.pop_ready(self.clock)
            slot = pool.allocate_pages(need, shared=shared, reuse_len=reuse)
            self._inflight[slot] = _InFlight(
                req=req, slot=slot,
                admitted_at=(self.clock if parked is None
                             else parked.admitted_at),
                prefilled=reuse,
                prior=(list(parked.generated) if parked is not None else []),
                orig_req=(parked.req if parked is not None else None))
            if parked is not None:
                self.stats["resumed"] += 1

    def _cover_pages(self, fresh_needed: int, shared: Sequence[int],
                     priority: int) -> bool:
        """Climb the exhaustion ladder until ``fresh_needed`` pages are
        free: evict LRU index entries, then preempt strictly-lower-priority
        victims (each publishes its computed pages, so eviction runs again
        behind it). False when the ladder is exhausted and the candidate
        must block head-of-line."""
        pool = self.pool

        def evict():
            if self.prefix_index is None:
                return
            protect = set(shared)
            while (fresh_needed > pool.n_free_pages
                   and self.prefix_index.evict_lru(pool, protect)):
                pass

        evict()
        while fresh_needed > pool.n_free_pages:
            victim = self._select_victim(priority)
            if victim is None:
                return False
            self._preempt_one(victim)
            evict()
        return True

    def _retire(self, fl: _InFlight, at: Optional[float] = None,
                status: str = "ok") -> None:
        req = fl.orig_req or fl.req
        self.results[req.rid] = RequestResult(
            rid=req.rid, prompt_len=len(req.prompt),
            tokens=fl.prior + list(fl.generated), arrival=req.arrival,
            admitted_at=fl.admitted_at,
            finished_at=self.clock if at is None else at, status=status)
        del self._inflight[fl.slot]
        self.pool.release(fl.slot)
        self._emit_result(self.results[req.rid])

    def _quarantine(self, fl: _InFlight, at: Optional[float] = None) -> None:
        """Retire a row whose logits were non-finite, with the tokens it
        generated before the poisoned dispatch; no other row saw the
        poison. Its pages are not published."""
        self._inject_bad.discard(fl.req.rid)
        self._retire(fl, at=at, status="quarantined")
        self.stats["quarantined"] += 1

    def _select_victim(self, priority: int) -> Optional[_InFlight]:
        """Preemption victim for an admission at ``priority``: a
        strictly-lower-priority request in flight, the most recently
        admitted first (ties by slot id), skipping those whose resume could
        never be admitted again."""
        cands = [fl for fl in self._inflight.values()
                 if fl.req.priority < priority and self._resumable(fl)]
        if not cands:
            return None
        return max(cands, key=lambda fl: (fl.admitted_at, fl.slot))

    def _resumable(self, fl: _InFlight) -> bool:
        """Whether a preempted ``fl`` could be admitted again: its resume
        prompt (prompt + everything generated) must still fit the ring and
        the page pool after prefill-chunk padding."""
        P = len(fl.req.prompt) + len(fl.generated)
        G = fl.remaining
        if G < 1:
            return False
        need = required_cache_len(P, G, self.prefill_chunk)
        if need > self.max_len:
            return False
        if self.paged and -(-need // self.page_size) > self.pool.num_pages:
            return False
        return True

    def _preempt_one(self, fl: _InFlight) -> None:
        """Preempt ``fl``: publish its computed pages to the prefix index (a
        resume maps them back instead of recomputing; if pool pressure
        evicts them first, the resume prefills again, still bit-identical),
        park the request on the host, and release the slot. The cache holds
        the prompt and every generated token but the last (its K/V lands
        with the next decode feed): exactly the prefix published."""
        if self.prefix_index is not None:
            if fl.prefill_done:
                covered = list(fl.req.prompt) + fl.generated[:-1]
            else:
                # mid-prefill: the committed chunks cover prompt[:prefilled]
                covered = list(fl.req.prompt[:fl.prefilled])
            if len(covered) >= self.page_size:
                self.prefix_index.publish(covered, self.pool, fl.slot)
        self._parked.append(_Parked(req=fl.orig_req or fl.req,
                                    generated=fl.prior + list(fl.generated),
                                    admitted_at=fl.admitted_at))
        del self._inflight[fl.slot]
        self.pool.release(fl.slot)
        self.stats["preempted"] += 1

    def preempt(self, rid: int) -> None:
        """Preempt an in-flight request by id: its slot and pages are
        released and it parks on the host, resuming through admission
        (before any queued request) with bit-identical final tokens.
        Raises KeyError for a request not in flight, ValueError when its
        resume could never fit (``_resumable``)."""
        for fl in self._inflight.values():
            if fl.req.rid == rid:
                if not self._resumable(fl):
                    raise ValueError(
                        f"request {rid} cannot be preempted: its resume "
                        f"prompt would exceed the engine's capacity")
                self._preempt_one(fl)
                return
        raise KeyError(f"request {rid} is not in flight")

    def cancel(self, rid: int) -> bool:
        """Client cancellation. A queued request is dropped at once; an
        in-flight or parked one at the next step boundary, with the tokens
        generated so far, status "cancelled". False when the rid is unknown
        (finished, or never submitted)."""
        self._tell("cancel", rid)
        if any(fl.req.rid == rid for fl in self._inflight.values()):
            self._cancelled.add(rid)
            return True
        if any(p.req.rid == rid for p in self._parked):
            self._cancelled.add(rid)
            return True
        req = self.scheduler.remove(rid)
        if req is not None:
            self._drop_result(req, "cancelled")
            self.stats["cancelled"] += 1
            return True
        return False

    def request_drain(self) -> None:
        """Graceful drain: close admission — new ``submit`` calls shed with
        ``QueueFull``, queued requests stay unserved — but finish everything
        in flight, parked (preempted) requests included."""
        self._tell("request_drain")
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def _reap(self) -> None:
        """Step-boundary reaping: cancel and expire in-flight requests (their
        partial tokens returned, their pages released). Queued and parked
        requests are reaped at admission."""
        for slot in sorted(self._inflight):
            fl = self._inflight[slot]
            rid = fl.req.rid
            if rid in self._cancelled:
                self._cancelled.discard(rid)
                self._retire(fl, status="cancelled")
                self.stats["cancelled"] += 1
            elif fl.req.deadline is not None and fl.req.deadline <= self.clock:
                self._retire(fl, status="expired")
                self.stats["expired"] += 1

    def check_invariants(self) -> None:
        """Audit the pool against every page pin the engine knows of (the
        prefix index); raises AssertionError on a violation."""
        ext: dict[int, int] = {}
        if self.prefix_index is not None:
            for page in self.prefix_index.pages():
                ext[page] = ext.get(page, 0) + 1
        self.pool.check_invariants(external_refs=ext)

    def inject_bad(self, rid: int) -> None:
        """Chaos hook: treat ``rid``'s row as non-finite at its next host
        sync (prefill completion or a decode boundary), without poisoning
        device state."""
        self._inject_bad.add(rid)

    def _finish_prefill(self, fl: _InFlight, first: int) -> None:
        if self.prefix_index is not None:
            # publish at prefill COMPLETION, so requests right behind the
            # donor already share its pages
            self.prefix_index.publish(fl.req.prompt, self.pool, fl.slot)
        fl.generated.append(first)
        fl.cur_token = first
        self.stats["generated_tokens"] += 1
        self._emit_tokens(fl, [first], self.clock)
        if fl.done:
            self._retire(fl)

    def _prefill_phase(self) -> None:
        C = self.prefill_chunk
        for slot in sorted(self._inflight):
            fl = self._inflight[slot]
            if fl.prefill_done:
                continue
            prompt = np.asarray(fl.req.prompt, np.int64)
            n = min(C, len(prompt) - fl.prefilled)
            chunk = np.zeros((1, C), np.int64)
            chunk[0, :n] = prompt[fl.prefilled:fl.prefilled + n]
            tok, bad = self._prefill_chunk_impl(chunk, slot, n)
            fl.prefilled += n
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_dispatches"] += 1
            if fl.prefill_done:
                self.stats["host_syncs"] += 1
                tok_bad = torch.stack([tok, bad.to(tok.dtype)]).tolist()
                if tok_bad[1] or fl.req.rid in self._inject_bad:
                    self._quarantine(fl)
                else:
                    self._finish_prefill(fl, int(tok_bad[0]))

    def _prefill_phase_fast(self) -> None:
        """One full-width [B, C] dispatch covering every prefilling slot in
        slot position; syncs only when some row consumed its final prompt
        chunk this step."""
        C = self.prefill_chunk
        pending = [self._inflight[s] for s in sorted(self._inflight)
                   if not self._inflight[s].prefill_done]
        if not pending:
            return
        B = self.num_slots
        tokens = np.zeros((B, C), np.int64)
        n_valid = np.ones((B,), np.int64)   # pads select position 0's logits
        fresh = np.zeros((B,), bool)
        is_real = np.zeros((B,), bool)
        for fl in pending:
            s = fl.slot
            prompt = np.asarray(fl.req.prompt, np.int64)
            n = min(C, len(prompt) - fl.prefilled)
            tokens[s, :n] = prompt[fl.prefilled:fl.prefilled + n]
            n_valid[s], fresh[s], is_real[s] = n, fl.fresh, True
        tok, bad = self._dispatch("prefill_multi", B,
                                  (tokens, n_valid, fresh, is_real))
        self.stats["prefill_chunks"] += len(pending)
        self.stats["prefill_dispatches"] += 1
        finishers = []
        for fl in pending:
            if fl.fresh:
                fl.fresh = False
                # the deferred reset just committed inside the dispatch
                self.pool.note_reset_committed(fl.slot)
            fl.prefilled += int(n_valid[fl.slot])
            if fl.prefill_done:
                finishers.append(fl)
        if finishers:
            tok_np, bad_np = torch.stack([tok, bad.to(tok.dtype)]).tolist()
            self.stats["host_syncs"] += 1
            for fl in finishers:
                if bad_np[fl.slot] or fl.req.rid in self._inject_bad:
                    self._quarantine(fl)
                else:
                    self._finish_prefill(fl, int(tok_np[fl.slot]))

    def _decode_phase(self) -> None:
        active = [fl for fl in self._inflight.values()
                  if fl.prefill_done and not fl.done]
        if not active:
            return
        tokens = np.zeros((self.num_slots, 1), np.int64)
        mask = np.zeros((self.num_slots,), bool)
        for fl in active:
            tokens[fl.slot, 0] = fl.cur_token
            mask[fl.slot] = True
        nxt, bad = self._decode(torch.from_numpy(tokens).to(self.device),
                                torch.from_numpy(mask).to(self.device))
        nxt_np, bad_np = torch.stack([nxt, bad.to(nxt.dtype)]).tolist()
        self.stats["decode_steps"] += 1
        self.stats["decode_dispatches"] += 1
        self.stats["host_syncs"] += 1
        for fl in active:
            if bad_np[fl.slot] or fl.req.rid in self._inject_bad:
                self._quarantine(fl)
                continue
            tok = int(nxt_np[fl.slot])
            fl.generated.append(tok)
            fl.cur_token = tok
            self.stats["generated_tokens"] += 1
            self._emit_tokens(fl, [tok], self.clock)
            if fl.done:
                self._retire(fl)

    def _choose_horizon(self, active) -> int:
        """Adaptive K: fuse as many decode steps as possible without moving
        any retire/admit/expire/prefill event off its stepwise-path clock
        tick, rounded down to a power of two (every cap is an upper bound,
        so the schedule stays tick-exact and the shapes number
        log2(horizon)+1)."""
        k = min(self.decode_horizon, min(fl.remaining for fl in active))
        if any(not fl.prefill_done for fl in self._inflight.values()):
            # a prefilling slot advances one chunk per engine tick; a long
            # horizon would starve it, so fall back to stepwise cadence
            return 1
        deadlines = [fl.req.deadline for fl in self._inflight.values()
                     if fl.req.deadline is not None]
        if deadlines:
            # expiry is reaped at step starts (clock >= deadline): the
            # horizon must not coast past the earliest one
            k = min(k, max(1, int(math.ceil(min(deadlines) - self.clock))))
        if self.pool.n_free:
            nxt = self.scheduler.peek_arrival()
            if nxt is not None:
                if nxt <= self.clock:
                    # head is ready and a slot freed mid-step (prefill
                    # retire): admit on the very next tick, like stepwise
                    return 1
                # a free slot waits on the FIFO head's arrival: admission
                # must not be delayed past it by a long horizon
                k = min(k, int(math.ceil(nxt - self.clock)))
        return _pow2_floor(k)

    def _decode_phase_fast(self) -> int:
        """A decode horizon; returns the number of decode steps run (the
        engine-clock ticks this phase consumed)."""
        active = [fl for fl in self._inflight.values()
                  if fl.prefill_done and not fl.done]
        if not active:
            return 1
        k = self._choose_horizon(active)
        tokens = np.zeros((self.num_slots, 1), np.int64)
        remaining = np.zeros((self.num_slots,), np.int64)
        for fl in active:
            tokens[fl.slot, 0] = fl.cur_token
            # cap at k: the dispatch must not generate past this horizon
            remaining[fl.slot] = min(fl.remaining, k)
        toks, bad = self._dispatch("decode_horizon", k, (tokens, remaining))
        # the horizon's single host sync
        out = torch.cat([toks, bad[:, None].to(toks.dtype)], dim=1).tolist()
        self.stats["decode_steps"] += k
        self.stats["decode_dispatches"] += 1
        self.stats["host_syncs"] += 1
        for fl in active:
            row = out[fl.slot]
            if row[k] or fl.req.rid in self._inject_bad:
                # the bad flag is OR-ed across the horizon: the row's whole
                # horizon is untrusted and dropped (other rows untouched)
                self._quarantine(fl, at=self.clock + k - 1)
                continue
            new = [int(t) for t in row[:k]]
            fl.generated.extend(new)
            fl.cur_token = new[-1]
            self.stats["generated_tokens"] += k
            self._emit_tokens(fl, new, self.clock)
            if fl.done:
                # the last token landed on the horizon's final tick
                self._retire(fl, at=self.clock + k - 1)
        return k

    def step(self) -> None:
        """One engine iteration: reap → admit → chunked prefill → batched
        decode. On the fast path a decode horizon advances the clock by K
        ticks (one a generated-token step, as on the stepwise path)."""
        self._tell("step")
        t0 = time.monotonic()
        with tier_scope(self.backend), tp_scope(self.shard):
            ticks = self._step()
        self.stats["engine_steps"] += ticks
        self.clock += float(ticks)
        if self.straggler.observe(self.stats["engine_steps"],
                                  time.monotonic() - t0):
            self.stats["straggler_steps"] += 1
        if self._pool_check:
            self.check_invariants()

    def _step(self) -> int:
        """The phases of one ``step``; returns the ticks it advanced."""
        self._reap()
        self._admit()
        occ_pre = len(self._inflight) / self.num_slots
        if self.fast:
            self._prefill_phase_fast()
            # a gen-at-prefill request may have retired above; ticks 2..K
            # of the horizon see that state (no admission lands
            # mid-horizon, decode retires only on the final tick), so the
            # occupancy stays tick-identical to the stepwise path
            occ_post = len(self._inflight) / self.num_slots
            ticks = self._decode_phase_fast()
            self.stats["occupancy_sum"] += occ_pre + occ_post * (ticks - 1)
        else:
            self._prefill_phase()
            self._decode_phase()
            ticks = 1
            self.stats["occupancy_sum"] += occ_pre
        return ticks

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> dict[int, RequestResult]:
        """Submit ``requests`` (if given), step until drained, and return
        (and clear) the results. While ``request_drain()`` is in effect,
        queued requests are not served (admitted and parked work still
        finishes)."""
        for r in requests or ():
            self.submit(r)
        while (self._inflight or self._parked
               or (not self._draining and self.scheduler.pending())):
            self.step()
        out, self.results = self.results, {}
        return out

    # ------------------------------------------------------------ shapes
    def warmup_shapes(self) -> set:
        """The (dispatch, dim) pairs ``warmup()`` runs: the full-width
        prefill and every power-of-two decode horizon on the fast path
        (each one CUDA graph on the card); the stepwise shapes otherwise."""
        if not self.fast:
            return {("prefill", 1), ("decode", 1)}
        horizons = {1 << i for i in range(self.decode_horizon.bit_length())
                    if 1 << i <= self.decode_horizon}
        return ({("prefill_multi", self.num_slots)}
                | {("decode_horizon", k) for k in horizons})

    def dispatch_shapes(self) -> set:
        """Every (dispatch, dim) the serving loop can dispatch: closed under
        ``warmup_shapes()``, so after ``warmup()`` no live step captures."""
        if not self.fast:
            return {("prefill", 1), ("decode", 1)}
        horizons = {_pow2_floor(k)
                    for k in range(1, self.decode_horizon + 1)}
        return ({("prefill_multi", self.num_slots)}
                | {("decode_horizon", k) for k in horizons})

    def warmup(self) -> dict:
        """Run every ``warmup_shapes()`` shape ahead of traffic — on the
        card, capture each fast-path graph — through throwaway requests in
        the real loop, so the served traffic replays instead of capturing.

        Side-effect-free: stats, clock, results, the straggler monitor, the
        scheduler's admission order, the prefix index (the throwaway
        ``[0]`` prompts run against a temporary index, cleared afterwards)
        and the pool — every cache leaf's bytes (paged: every page and the
        page table), restored by ``copy_`` into the same tensors, so no
        leaf changes its address, and the slot bookkeeping, the free-page
        heap in its order, the refcounts, the slots' pages and
        ``cow_copies`` — are as before. Returns what it ran on the device:
        ``seconds``, ``decode_steps`` and ``prefill_dispatches`` (its
        traffic's forwards plus the masked dispatch before each capture),
        and on the card the ``graphs`` captured so far, their
        ``capture_seconds`` and ``graph_pool_bytes``."""
        if self.scheduler.pending() or self._inflight or self._parked:
            raise RuntimeError(
                "warmup() needs an idle engine — it runs (and discards) "
                "throwaway requests through the serving loop")
        t0 = time.perf_counter()
        pool = self.pool
        snap_stats, snap_clock = dict(self.stats), self.clock
        snap_order = list(self.scheduler.admitted_order)
        snap_results = dict(self.results)
        snap_straggler, self.straggler = self.straggler, StragglerMonitor()
        # throwaway traffic must not stream into a wired front-end
        snap_cbs = (self._on_token, self._on_result)
        self._on_token = self._on_result = None
        snap_cache = {k: v.clone() for k, v in pool.cache.items()}
        snap_free, snap_alloc = set(pool._free), set(pool._allocated)
        snap_pending = set(pool._pending_reset)
        if pool.paged:
            snap_pages = list(pool._free_pages)
            snap_ref = list(pool._page_ref)
            snap_slot_pages = {s: list(p) for s, p in pool._slot_pages.items()}
            snap_cow = pool.cow_copies
        snap_index = self.prefix_index
        if snap_index is not None:
            self.prefix_index = PrefixIndex(self.page_size)
        snap_masked = dict(self._masked_forwards)
        # the throwaway traffic is the engine's own: a bounded admission
        # queue (max_queue below the slot count) must not refuse it
        snap_bound, self.scheduler.max_queue = self.scheduler.max_queue, None
        try:
            shapes = self.warmup_shapes()
            rid = -1
            widths = sorted(w for j, w in shapes if j.startswith("prefill"))
            for w in widths:             # prefill widths (no decode: gen 1)
                self.run([Request(rid=rid - j, prompt=[0], max_new_tokens=1)
                          for j in range(w)])
                rid -= w
            horizons = sorted(k for j, k in shapes if j.startswith("decode"))
            for k in horizons:           # decode horizons
                self.run([Request(rid=rid, prompt=[0],
                                  max_new_tokens=min(k + 1, self.max_len))])
                rid -= 1
            ran = {name: self.stats[name] - snap_stats[name]
                   + self._masked_forwards[name] - snap_masked[name]
                   for name in ("decode_steps", "prefill_dispatches")}
        finally:
            if snap_index is not None:
                # release the temporary index's pins, then restore the live
                # index untouched
                self.prefix_index.clear(pool)
                self.prefix_index = snap_index
            for k, leaf in pool.cache.items():
                leaf.copy_(snap_cache[k])
            pool._free, pool._allocated = snap_free, snap_alloc
            pool._pending_reset = snap_pending
            if pool.paged:
                pool._free_pages = snap_pages
                pool._page_ref = snap_ref
                pool._slot_pages = snap_slot_pages
                pool.cow_copies = snap_cow
            self.stats, self.clock = snap_stats, snap_clock
            self.results = snap_results
            self.straggler = snap_straggler
            self._on_token, self._on_result = snap_cbs
            self.scheduler.admitted_order.clear()
            self.scheduler.admitted_order.extend(snap_order)
            self.scheduler.max_queue = snap_bound
        if self.graphs is None:
            return {"seconds": time.perf_counter() - t0, **ran}
        torch.cuda.synchronize(self.device)
        return {"seconds": time.perf_counter() - t0, **ran,
                "graphs": len(self.graphs),
                "capture_seconds": self.graphs.capture_seconds,
                "graph_pool_bytes": self.graphs.pool_bytes}

    # ------------------------------------------------------------ metrics
    def view_bytes(self) -> int:
        """Bytes of the dense view a paged engine gathers into (0 when
        contiguous)."""
        if not self.paged:
            return 0
        return sum(t.numel() * t.element_size() for t in self.dense.values())

    def mean_occupancy(self) -> float:
        steps = self.stats["engine_steps"]
        return self.stats["occupancy_sum"] / steps if steps else 0.0

    def syncs_per_token(self) -> float:
        gen = self.stats["generated_tokens"]
        return self.stats["host_syncs"] / gen if gen else 0.0
