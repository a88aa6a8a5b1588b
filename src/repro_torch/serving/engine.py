"""Continuous-batching serving engine — the stepwise path over a contiguous
pool (port of ``repro.serving.engine.ServingEngine`` with ``fast=False``).

One engine step runs three phases over the slot-based KV-cache pool:

  1. **admit** — while a slot is free and the FIFO head has arrived, claim
     the lowest free slot (bookkeeping reset only; stale K/V is masked).
  2. **chunked prefill** — every admitted-but-unfinished request advances by
     one fixed-size prompt chunk. Each chunk is a full-width masked prefill:
     all ``num_slots`` rows run, the request's row in its slot position and
     zero rows elsewhere; the other rows' bookkeeping rolls back and their
     written ring window is restored, so a decoding slot riding along is
     untouched. The final chunk is zero-padded; pad writes are invalidated
     (kpos → -1) and the first generated token is read from the last valid
     position's logits.
  3. **batched decode** — one ``decode_step`` over the full slot batch with
     per-slot positions; rows that are not decoding ride along and their
     bookkeeping write is rolled back. Finished requests retire and their
     slots are reusable at once.

Every row's computation is independent of the others (masked keys
contribute exact zeros), so a request's tokens do not depend on what else is
in the batch. Non-finite logits quarantine their row at the next host sync.

Unlike the JAX engine, which donates the cache to each jitted step, the
port updates ``pool.cache`` IN PLACE: the model writes the int8 K/V payload
into the pool's own tensors, and the engine rebinds only the small
``kpos`` / ``pos`` bookkeeping tensors. The JAX engine's device-resident
fast path, paged pool, deadlines, cancellation and preemption are later
slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .cache_pool import KNOWN_BOOKKEEPING, CachePool
from .errors import QueueFull, RequestTooLarge
from .scheduler import FIFOScheduler, Request


def required_cache_len(prompt_len: int, max_new_tokens: int,
                       prefill_chunk: int) -> int:
    """Ring positions a request needs: the zero-padded prefill chunks and
    the full decoded context."""
    padded = -(-prompt_len // prefill_chunk) * prefill_chunk
    return max(padded, prompt_len + max_new_tokens - 1)


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

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= len(self.req.prompt)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new_tokens


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
    prefill_chunk: prompt-chunk length. kv_bits: 8 (the int8 cache is the
    only one ported). max_queue: bound on the admission queue (``submit``
    beyond it raises the retryable ``QueueFull``). device: where the pool
    lives and the params must live; the card unless ``device="cpu"``.
    """

    def __init__(self, model, params, cfg, *, num_slots: int = 4,
                 max_len: int = 128, prefill_chunk: int = 16,
                 kv_bits: int = 8, max_queue: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine serves on {self.device}")
        self.model = model
        self.params = params
        model.prepare(params)        # the compute-dtype cast, out of the loop
        self.cfg = cfg
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.pool = CachePool(model, num_slots, max_len, device=self.device,
                              kv_bits=kv_bits)
        self.kv_bits = self.pool.kv_bits
        self.max_len = self.pool.max_len
        self.scheduler = FIFOScheduler(max_queue=max_queue)
        self.clock = 0.0
        self._inflight: dict[int, _InFlight] = {}
        self.results: dict[int, RequestResult] = {}
        self.stats = {
            "decode_steps": 0,        # token-level decode steps
            "decode_dispatches": 0,   # model decode calls
            "prefill_chunks": 0,      # chunk-level prefill advances
            "prefill_dispatches": 0,  # model prefill calls
            "host_syncs": 0,          # device → host reads
            "generated_tokens": 0,
            "occupancy_sum": 0.0,     # Σ per-step slot occupancy
            "engine_steps": 0,
            "shed": 0,                # submissions rejected (QueueFull)
            "quarantined": 0,         # non-finite rows retired
        }

    # ------------------------------------------------------- device steps
    def _prefill_masked(self, tokens, n_valid, is_real):
        """Full-width masked prefill: every pool slot advances one chunk in
        slot position. tokens [B, C] (zero rows for slots not prefilling);
        n_valid [B] (1 for pad rows); is_real [B]. Pad rows run for shape
        stability; their bookkeeping rolls back and their C-wide ring window
        — saved before the model's in-place appends — is restored, so their
        cache bytes are unchanged. Returns per-row greedy tokens from each
        row's last valid position and the non-finite flag of the real rows.
        """
        cache = self.pool.cache
        C = tokens.shape[1]
        S = cache["kpos"].shape[1]
        start = cache["pos"]
        win = (start[:, None]
               + torch.arange(C, device=start.device)[None, :]) % S   # [B, C]
        payload = [k for k in cache if k not in KNOWN_BOOKKEEPING]
        saved = {k: _take_window(cache[k], win) for k in payload}
        logits, sub = self.model.prefill(self.params, tokens, cache,
                                         logits_at=n_valid - 1)
        end = start + n_valid
        kpos = torch.where(sub["kpos"] >= end[:, None], -1, sub["kpos"])
        for k in payload:
            keep = is_real.reshape((1, -1) + (1,) * (saved[k].ndim - 2))
            _put_window(cache[k], win,
                        torch.where(keep, _take_window(cache[k], win), saved[k]))
        cache["kpos"] = torch.where(is_real[:, None], kpos, cache["kpos"])
        cache["pos"] = torch.where(is_real, end, cache["pos"])
        tok = torch.argmax(logits, dim=-1)
        bad = ~torch.isfinite(logits).all(dim=-1) & is_real
        return tok, bad

    def _prefill_chunk_impl(self, chunk: np.ndarray, slot: int, n_valid: int):
        """One prompt chunk [1, C] into ``slot``, as the slot's row of a
        full-width masked prefill. Returns (token, non-finite flag) of the
        slot's row, still on the device."""
        B, C = self.num_slots, chunk.shape[1]
        tokens = np.zeros((B, C), np.int64)
        tokens[slot] = chunk[0]
        n_vec = np.ones((B,), np.int64)
        n_vec[slot] = n_valid
        is_real = np.arange(B) == slot
        dev = self.device
        tok, bad = self._prefill_masked(torch.from_numpy(tokens).to(dev),
                                        torch.from_numpy(n_vec).to(dev),
                                        torch.from_numpy(is_real).to(dev))
        return tok[slot], bad[slot]

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
        cache["kpos"] = torch.where((~active)[:, None] & wrote, -1, new["kpos"])
        cache["pos"] = torch.where(active, new["pos"], prev_pos)
        bad = ~torch.isfinite(logits).all(dim=-1) & active
        return torch.argmax(logits, dim=-1), bad

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
            slot = self.pool.allocate()
            self._inflight[slot] = _InFlight(req=req, slot=slot,
                                             admitted_at=self.clock)

    def _retire(self, fl: _InFlight, status: str = "ok") -> None:
        self.results[fl.req.rid] = RequestResult(
            rid=fl.req.rid, prompt_len=len(fl.req.prompt),
            tokens=list(fl.generated), arrival=fl.req.arrival,
            admitted_at=fl.admitted_at, finished_at=self.clock, status=status)
        del self._inflight[fl.slot]
        self.pool.release(fl.slot)

    def _quarantine(self, fl: _InFlight) -> None:
        """Retire a row whose logits were non-finite, with the tokens it
        generated before; no other row saw the poison."""
        self._retire(fl, status="quarantined")
        self.stats["quarantined"] += 1

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
                    continue
                fl.generated.append(int(tok_bad[0]))
                fl.cur_token = int(tok_bad[0])
                self.stats["generated_tokens"] += 1
                if fl.done:
                    self._retire(fl)

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

    def step(self) -> None:
        """One engine iteration: admit → chunked prefill → batched decode."""
        self._admit()
        self.stats["occupancy_sum"] += len(self._inflight) / self.num_slots
        self._prefill_phase()
        self._decode_phase()
        self.stats["engine_steps"] += 1
        self.clock += 1.0

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

    # ------------------------------------------------------------ metrics
    def mean_occupancy(self) -> float:
        steps = self.stats["engine_steps"]
        return self.stats["occupancy_sum"] / steps if steps else 0.0

    def syncs_per_token(self) -> float:
        gen = self.stats["generated_tokens"]
        return self.stats["host_syncs"] / gen if gen else 0.0
