"""Continuous-batching serving engine over a contiguous KV pool, int8 or fp
(port of ``repro.serving.engine.ServingEngine``).

One engine step runs three phases over the slot-based KV-cache pool:

  1. **admit** — while a slot is free and the FIFO head has arrived, claim
     the lowest free slot (bookkeeping reset only; stale K/V is masked).
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
    remaining budget, next scheduled arrival - clock)``, rounded down to a
    power of two; 1 while any prefill is in flight), so retirement,
    admission and prefill land on exactly the stepwise path's ticks. On the
    card each ``(dispatch, shape)`` of ``warmup_shapes()`` is a CUDA graph
    (``graphs.py``) captured from the same code the CPU runs eagerly, at
    its first dispatch or at ``warmup()``: the batched prefill, and one
    graph a power-of-two horizon with its K steps unrolled.
  * the **stepwise reference** (``fast=False``): one full-width dispatch a
    prefill chunk, one decode step an engine step, one host sync each —
    kept as the parity oracle.

Every row's computation is independent of the others (masked keys
contribute exact zeros), so a request's tokens do not depend on what else
is in the batch, nor on the path. Non-finite logits quarantine their row at
the next host sync.

Unlike the JAX engine, which donates the cache to each jitted step, the
port updates ``pool.cache`` IN PLACE and never rebinds a leaf: the model
writes the K/V payload into the pool's own tensors, and the engine
copies the ``kpos`` / ``pos`` bookkeeping into them. A captured graph holds
those addresses. The JAX engine's paged pool, deadlines, cancellation,
preemption and streaming callbacks are later slices of the port.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.dispatch import TIERS, tier_scope
from ..runtime.fault_tolerance import StragglerMonitor
from .cache_pool import KNOWN_BOOKKEEPING, CachePool
from .errors import QueueFull, RequestTooLarge
from .scheduler import FIFOScheduler, Request


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
class RequestResult:
    rid: int
    prompt_len: int
    tokens: list  # generated token ids
    arrival: float
    admitted_at: float
    finished_at: float
    status: str = "ok"          # "ok" | "quarantined" (non-finite logits)


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
    model gets the int8 cache). backend: the kernel tier every op of the
    engine's forwards resolves at (``cuda`` | ``torch``; None: the
    registry's rule, ``REPRO_KERNEL_BACKEND`` then the device). max_queue: bound on the admission queue (``submit`` beyond it
    raises the retryable ``QueueFull``). straggler: a ``StragglerMonitor``
    observing each engine step's wall time (``stats["straggler_steps"]``);
    None = defaults. device: where the pool lives and the params must
    live; the card unless ``device="cpu"``.

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
                 max_queue: Optional[int] = None,
                 straggler: Optional[StragglerMonitor] = None,
                 device="cuda", backend: Optional[str] = None):
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
                              kv_bits=kv_bits)
        self.kv_bits = self.pool.kv_bits
        self.max_len = self.pool.max_len
        self.scheduler = FIFOScheduler(max_queue=max_queue)
        self.straggler = straggler or StragglerMonitor()
        self.graphs = None
        if fast and self.device.type == "cuda":
            from .graphs import EngineGraphs

            self.graphs = EngineGraphs(self.device)
        # forwards of the masked dispatches run before each capture (they
        # are in no stat: warmup reports them)
        self._masked_forwards = {"decode_steps": 0, "prefill_dispatches": 0}
        self.clock = 0.0
        self._inflight: dict[int, _InFlight] = {}
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
            "shed": 0,                # submissions rejected (QueueFull)
            "quarantined": 0,         # non-finite rows retired
            "straggler_steps": 0,     # engine steps flagged by the monitor
            # what "slow" means for the monitor (a config echo)
            "straggler_threshold": float(getattr(self.straggler,
                                                 "threshold", 0.0)),
        }

    @classmethod
    def from_quantized(cls, qm, **kwargs) -> "ServingEngine":
        """Build an engine over a pipeline ``QuantizedModel``."""
        return cls(qm.model, qm.params, qm.cfg, **kwargs)

    # ------------------------------------------------------- device steps
    def _prefill_masked(self, tokens, n_valid, fresh, is_real):
        """Full-width masked prefill: every pool slot advances one chunk in
        slot position. tokens [B, C] (zero rows for slots not prefilling);
        n_valid [B] (1 for pad rows: they select position 0's logits);
        fresh [B] rows whose bookkeeping reset (kpos → -1, pos → 0) was
        deferred from ``CachePool.allocate(reset=False)``; is_real [B].
        Pad rows run for shape stability; their bookkeeping rolls back and
        their C-wide ring window — saved before the model's in-place
        appends — is restored, so their cache bytes are unchanged. Returns
        per-row greedy tokens from each row's last valid position and the
        non-finite flag of the real rows. Reads no tensor back to the host.
        """
        cache = self.pool.cache
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
        tok = torch.argmax(logits, dim=-1)
        bad = ~torch.isfinite(logits).all(dim=-1) & is_real
        return tok, bad

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
        tok, bad = self._prefill_masked(torch.from_numpy(tokens).to(dev),
                                        torch.from_numpy(n_vec).to(dev),
                                        torch.zeros((B,), dtype=torch.bool,
                                                    device=dev),
                                        torch.from_numpy(is_real).to(dev))
        return tok[slot], bad[slot]

    def _prefill_multi_impl(self, tokens, n_valid, fresh, is_real):
        """All prefilling slots advance one chunk in ONE full-width
        dispatch (see ``_prefill_masked``): one shape, [num_slots, C],
        covers every prefill step of the fast path."""
        return self._prefill_masked(tokens, n_valid, fresh, is_real)

    def _decode_masked(self, tokens, active):
        """One full-slot-batch decode step. Rows not in ``active`` ride along;
        their bookkeeping write (one kpos entry, the pos advance) is rolled
        back — their K/V payload write is masked by kpos = -1 and overwritten
        by the slot's next real token at the same ring index."""
        cache = self.pool.cache
        prev_pos = cache["pos"]
        logits, new = self.model.decode_step(self.params, tokens, cache)
        S = cache["kpos"].shape[1]
        wrote = (torch.arange(S, device=prev_pos.device)[None, :]
                 == (prev_pos % S)[:, None])
        kpos = torch.where((~active)[:, None] & wrote, -1, new["kpos"])
        pos = torch.where(active, new["pos"], prev_pos)
        cache["kpos"].copy_(kpos)
        cache["pos"].copy_(pos)
        bad = ~torch.isfinite(logits).all(dim=-1) & active
        return torch.argmax(logits, dim=-1), bad

    def _decode_horizon_impl(self, tokens, remaining, *, k: int):
        """K decode steps in one dispatch, one host sync.

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
            nxt, bad = self._decode_masked(tokens, active)
            tokens = torch.where(active[:, None], nxt[:, None], tokens)
            remaining = torch.where(active, remaining - 1, remaining)
            bad_any = bad_any | bad
            toks.append(nxt)
        return torch.stack(toks, dim=1), bad_any

    def _fast_impl(self, name: str, dim: int):
        if name == "prefill_multi":
            return self._prefill_multi_impl
        return functools.partial(self._decode_horizon_impl, k=dim)

    def _masked_args(self, name: str) -> tuple:
        """The dispatch ``name`` with every row masked: pad prefill rows,
        or no decode budget. It leaves bookkeeping and live K/V as they
        were (the ride-along rules above)."""
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
        if request.deadline is not None:
            raise NotImplementedError(
                f"request {request.rid}: deadlines are not ported yet")
        P, G = len(request.prompt), request.max_new_tokens
        need = required_cache_len(P, G, self.prefill_chunk)
        if need > self.max_len:
            raise RequestTooLarge(
                f"request {request.rid}: needs {need} cache positions "
                f"(prompt {P}, gen {G}, chunk {self.prefill_chunk}) but "
                f"max_len={self.max_len}")
        try:
            self.scheduler.submit(request)
        except QueueFull:
            self.stats["shed"] += 1
            raise

    def _admit(self) -> None:
        while self.pool.n_free:
            req = self.scheduler.pop_ready(self.clock)
            if req is None:
                return
            # fast path: the slot's bookkeeping reset is deferred into its
            # first prefill chunk (the fresh mask) — admission dispatches
            # nothing
            slot = self.pool.allocate(reset=not self.fast)
            self._inflight[slot] = _InFlight(req=req, slot=slot,
                                             admitted_at=self.clock,
                                             fresh=self.fast)

    def _retire(self, fl: _InFlight, at: Optional[float] = None,
                status: str = "ok") -> None:
        self.results[fl.req.rid] = RequestResult(
            rid=fl.req.rid, prompt_len=len(fl.req.prompt),
            tokens=list(fl.generated), arrival=fl.req.arrival,
            admitted_at=fl.admitted_at,
            finished_at=self.clock if at is None else at, status=status)
        del self._inflight[fl.slot]
        self.pool.release(fl.slot)

    def _quarantine(self, fl: _InFlight, at: Optional[float] = None) -> None:
        """Retire a row whose logits were non-finite, with the tokens it
        generated before; no other row saw the poison."""
        self._retire(fl, at=at, status="quarantined")
        self.stats["quarantined"] += 1

    def _finish_prefill(self, fl: _InFlight, first: int) -> None:
        fl.generated.append(first)
        fl.cur_token = first
        self.stats["generated_tokens"] += 1
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
                if tok_bad[1]:
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
                if bad_np[fl.slot]:
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
        nxt, bad = self._decode_masked(
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(mask).to(self.device))
        nxt_np, bad_np = torch.stack([nxt, bad.to(nxt.dtype)]).tolist()
        self.stats["decode_steps"] += 1
        self.stats["decode_dispatches"] += 1
        self.stats["host_syncs"] += 1
        for fl in active:
            if bad_np[fl.slot]:
                self._quarantine(fl)
                continue
            tok = int(nxt_np[fl.slot])
            fl.generated.append(tok)
            fl.cur_token = tok
            self.stats["generated_tokens"] += 1
            if fl.done:
                self._retire(fl)

    def _choose_horizon(self, active) -> int:
        """Adaptive K: fuse as many decode steps as possible without moving
        any retire/admit/prefill event off its stepwise-path clock tick,
        rounded down to a power of two (every cap is an upper bound, so the
        schedule stays tick-exact and the shapes number log2(horizon)+1).
        The port refuses deadlines at ``submit``, so there is no deadline
        cap."""
        k = min(self.decode_horizon, min(fl.remaining for fl in active))
        if any(not fl.prefill_done for fl in self._inflight.values()):
            # a prefilling slot advances one chunk per engine tick; a long
            # horizon would starve it, so fall back to stepwise cadence
            return 1
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
            if row[k]:
                # the bad flag is OR-ed across the horizon: the row's whole
                # horizon is untrusted and dropped (other rows untouched)
                self._quarantine(fl, at=self.clock + k - 1)
                continue
            new = [int(t) for t in row[:k]]
            fl.generated.extend(new)
            fl.cur_token = new[-1]
            self.stats["generated_tokens"] += k
            if fl.done:
                # the last token landed on the horizon's final tick
                self._retire(fl, at=self.clock + k - 1)
        return k

    def step(self) -> None:
        """One engine iteration: admit → chunked prefill → batched decode.
        On the fast path a decode horizon advances the clock by K ticks
        (one a generated-token step, as on the stepwise path)."""
        t0 = time.monotonic()
        with tier_scope(self.backend):
            ticks = self._step()
        self.stats["engine_steps"] += ticks
        self.clock += float(ticks)
        if self.straggler.observe(self.stats["engine_steps"],
                                  time.monotonic() - t0):
            self.stats["straggler_steps"] += 1

    def _step(self) -> int:
        """The phases of one ``step``; returns the ticks it advanced."""
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
        (and clear) the results."""
        for r in requests or ():
            self.submit(r)
        while self._inflight or self.scheduler.pending():
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
        scheduler's admission order and the pool — every cache leaf's
        bytes, restored by ``copy_`` into the same tensors, so no leaf
        changes its address, and the free / allocated / pending-reset
        bookkeeping — are as before. Returns what it ran on the device:
        ``seconds``, ``decode_steps`` and ``prefill_dispatches`` (its
        traffic's forwards plus the masked dispatch before each capture),
        and on the card the ``graphs`` captured so far, their
        ``capture_seconds`` and ``graph_pool_bytes``."""
        if self.scheduler.pending() or self._inflight:
            raise RuntimeError(
                "warmup() needs an idle engine — it runs (and discards) "
                "throwaway requests through the serving loop")
        t0 = time.perf_counter()
        pool = self.pool
        snap_stats, snap_clock = dict(self.stats), self.clock
        snap_order = list(self.scheduler.admitted_order)
        snap_results = dict(self.results)
        snap_straggler, self.straggler = self.straggler, StragglerMonitor()
        snap_cache = {k: v.clone() for k, v in pool.cache.items()}
        snap_free, snap_alloc = set(pool._free), set(pool._allocated)
        snap_pending = set(pool._pending_reset)
        snap_masked = dict(self._masked_forwards)
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
            for k, leaf in pool.cache.items():
                leaf.copy_(snap_cache[k])
            pool._free, pool._allocated = snap_free, snap_alloc
            pool._pending_reset = snap_pending
            self.stats, self.clock = snap_stats, snap_clock
            self.results = snap_results
            self.straggler = snap_straggler
            self.scheduler.admitted_order.clear()
            self.scheduler.admitted_order.extend(snap_order)
        if self.graphs is None:
            return {"seconds": time.perf_counter() - t0, **ran}
        torch.cuda.synchronize(self.device)
        return {"seconds": time.perf_counter() - t0, **ran,
                "graphs": len(self.graphs),
                "capture_seconds": self.graphs.capture_seconds,
                "graph_pool_bytes": self.graphs.pool_bytes}

    # ------------------------------------------------------------ metrics
    def mean_occupancy(self) -> float:
        steps = self.stats["engine_steps"]
        return self.stats["occupancy_sum"] / steps if steps else 0.0

    def syncs_per_token(self) -> float:
        gen = self.stats["generated_tokens"]
        return self.stats["host_syncs"] / gen if gen else 0.0
