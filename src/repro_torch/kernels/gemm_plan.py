"""The split-K planner both GEMM wrappers share (``csrc/gemm_mainloop.cuh``).

Each GEMM kernel tiles the output [M, N] into BM x BN blocks (``TILES``: a
decode batch, M <= 16, takes 16 x 16 tiles of eight one-warp groups; up to
a prefill chunk, M <= 256, 64 x 32 tiles of two four-warp groups; a larger
M 128 x 64 tiles of one eight-warp group) and walks K in steps
of BK = 64 elements; each group of a CTA walks its share of the CTA's steps
through a ring of its own. K may also be split across CTAs: the grid is
N-tiles x M-tiles x S, split s walks the K steps
``[s * k_steps // S, (s + 1) * k_steps // S)``, and the S splits of a tile
are one thread block cluster that adds its partials through distributed
shared memory in the same launch.

S is the smallest number of splits that leaves no CTA more than
``MAX_STEPS`` K steps, capped so that every split keeps at least
``MIN_STEPS``, a cluster holds at most ``MAX_SPLITS`` CTAs and a split
never takes the grid past ``MAX_CTAS`` (4 CTAs an SM: past that the card
is full and the reduction is pure cost). The steps, not the number of SMs,
set S: the cluster's reduction costs about what a CTA of 8 warps takes to
walk 24 steps (chip_smoke.py's split sweep times every path shape at
several S). At the path's shapes this splits only the down projection
(K = 4864), in 4.

An expert-batched GEMM (the MoE block's: E experts' [M, K] x [K, N] in one
launch) puts its E x m_tiles M tiles on the grid's second axis — expert
``y // m_tiles``, M tile ``y % m_tiles`` — which no cluster spans, so a
tile's splits and its quantize-in neighbours are one expert's. ``plan(M,
N, K, experts=E)`` counts the E experts' tiles against ``MAX_CTAS``: at a
mixtral decode step the gate/up projections' 8 x 1024 tiles fill the card
without a split.

The W8A8 GEMM may also quantize its own activation (``fold``: the
quantize-in kernel of ``csrc/qmatmul_w8a8.cu``, one launch in place of
``quantize_act`` + the int8 GEMM, the same bits). Each CTA keeps its
split's slice of A resident in shared memory as int8 — ``bm`` x the
split's K steps x ``BK`` bytes beside a ring that then carries W only
(``qin_smem``) — so the fold is possible only where that fits
``QIN_SMEM_MAX`` (``qin_fits``; the wrapper refuses a call that does not).
Every CTA of an M tile needs the same slice, so ``share`` neighbouring N
tiles (a cluster with the K splits, at most ``MAX_SPLITS`` CTAs) divide the
quantizing: each reads and quantizes 1/share of the split's K steps and
writes its int8 into every peer's slice through distributed shared memory.
``share`` is the largest power of two up to ``MAX_SHARE`` that keeps a K
step a part and the cluster within ``MAX_SPLITS``.

The plan folds where it fits and the tile is a decode tile, ``bm in
FOLD_BM``, where the fold beats the pair it replaces: chip_smoke.py's
``qmatmul_w8a8_qin`` lines, NVIDIA H100 80GB HBM3 at 700 W, bf16 x and out,
fold / quantize_act + GEMM / the GEMM alone in µs, warm L2: M = 8 q/o
6.54 / 7.22 / 4.05, k/v 6.54 / 7.24 / 4.00, gate/up 8.06 / 8.50 / 5.25,
down 10.71 / 11.71 / 6.94 (weights from HBM: 6.72 / 7.95, 6.58 / 7.57,
8.56 / 9.78, 11.37 / 12.79). The fold's prologue is a chain of dependent
steps (load, max, exchange, quantize, copy) that the weight's latency
hides only in part, so a folded GEMM costs ~2.5-3.8 µs more than the GEMM
alone; the model folds only the first GEMM that reads an activation and
hands its int8 rows to the others. In a prefill chunk's 64-row tiles the
pair won everywhere — M = 256: q/o 14.98 / 11.35, gate/up 39.49 / 20.92,
down 49.87 / 25.10; M = 64: q/o 12.47 / 10.78 (the same lines, when the
kernel still had 64-row tiles) — since each CTA quantizes 64 rows of its
part (gate/up: 608 CTAs) against one quantize_act launch. So the kernel is
built for the decode tile alone, and its wrapper refuses any call the plan
does not fold.

The quantize-out GEMMs (``csrc/q8_epilogue.cuh``) take one of two routes,
``GemmPlan.q8_route``, chosen from the shape and the card's ``residency``:
the clusters of the kernel (CTAs where ``splits == 1``) the card keeps
resident at once, which the wrappers read from the card once per kernel
instantiation. ``"resident"`` where every tile of the launch is resident at
once (``tiles <= residency``; ``q8_plan`` may take a wider tile for that):
every CTA waits for its M tile's rows' max and quantizes its own tile from
its registers. ``"workspace"`` elsewhere (qwen2's vocabulary, N = 151936:
9,496 N tiles at the decode tile; the JAX bench's 4096^3): y goes to a
float32 workspace and the last ``q8_waiters`` CTAs of each M tile to finish
quantize its rows, the tiles going out by ticket, M tile by M tile, where
there is more than one M tile (``q8_ticketed``). The resident route may
also be forced where only an M tile's N tiles fit; its tiles then go out by
ticket too. ``plan(M, N, K, residency=R)`` prints the route; the choice is
never made on an error.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

TILES = {16: 16, 64: 32, 128: 64}  # BM: BN (gemm_mainloop.cuh: Tile<BM>)
GROUPS = {16: 8, 64: 2, 128: 1}    # BM: warp groups, a ring each (Tile<BM>)
STAGES = {16: 3, 64: 4, 128: 4}    # BM: stages of an int8 ring (Tile<BM>)
BK = 64           # K elements per ring step (gemm::BK)
MAX_STEPS = 24    # K steps a CTA walks at most, where K allows more splits
MIN_STEPS = 2     # K steps every split keeps at least
MAX_SPLITS = 16   # CTAs in a cluster (gemm::MAX_SPLITS; H100, non-portable)
MAX_CTAS = 4 * 132  # a split stops filling the H100's 132 SMs past this
QIN_SMEM_MAX = 217 * 1024  # the quantize-in GEMM's dynamic shared memory cap
FOLD_BM = (16,)     # the tiles whose GEMM quantizes its own activation
MAX_SHARE = 8       # N tiles that divide the quantizing of their A
Q8_ROUTES = ("resident", "workspace")  # the quantize-out epilogue's routes
Q8_WAITERS = 32     # workspace route: the CTAs of an M tile that quantize it


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def max_splits(k_steps: int) -> int:
    """The most splits that keep ``MIN_STEPS`` K steps each (at least 1)."""
    return max(1, min(k_steps // MIN_STEPS, MAX_SPLITS))


@dataclass(frozen=True)
class GemmPlan:
    M: int
    N: int
    K: int
    bm: int         # rows per CTA tile: 16, 64 or 128
    m_tiles: int
    n_tiles: int
    k_steps: int
    splits: int     # S, the CTAs of a cluster
    # the quantize-out kernel's resident clusters (CTAs where splits == 1)
    # on the card, as the wrappers read it; None where not given
    residency: Optional[int] = None
    q8_route: Optional[str] = None  # Q8_ROUTES[i], or None without residency
    experts: int = 1  # E, the experts of an expert-batched launch

    @property
    def tiles(self) -> int:
        """An expert's output tiles."""
        return self.m_tiles * self.n_tiles

    @property
    def ctas(self) -> int:
        return self.experts * self.tiles * self.splits

    @property
    def qin_smem(self) -> int:
        """Dynamic shared memory of the quantize-in kernel: its W-only ring
        and the int8 A slice of the longest split."""
        ring = GROUPS[self.bm] * STAGES[self.bm] * TILES[self.bm] * BK
        return ring + self.bm * _cdiv(self.k_steps, self.splits) * BK

    @property
    def qin_fits(self) -> bool:
        return self.qin_smem <= QIN_SMEM_MAX

    @property
    def share(self) -> int:
        """N tiles whose CTAs divide the quantizing of their A (the
        quantize-in kernel's cluster is share x splits CTAs): the largest
        power of two up to MAX_SHARE and the N tiles with a K step for
        each part of the shortest split and at most MAX_SPLITS CTAs a
        cluster."""
        steps = self.k_steps // self.splits
        share = 1
        while (share * 2 <= min(MAX_SHARE, steps, self.n_tiles)
               and share * 2 * self.splits <= MAX_SPLITS):
            share *= 2
        return share

    @property
    def fold(self) -> bool:
        """Whether the W8A8 GEMM quantizes its own activation (the wrappers'
        and the model's one rule)."""
        return self.bm in FOLD_BM and self.qin_fits

    @property
    def q8_ticketed(self) -> bool:
        """Whether the quantize-out kernel hands its tiles out by ticket, M
        tile by M tile, so that every CTA waited on is resident or holds no
        ticket yet: where the launch has more tiles (clusters) than the card
        keeps resident and more than one M tile, or (the forced resident
        route) more tiles than that. Else every CTA keeps its blockIdx's
        tile."""
        if self.q8_route == "resident":
            return self.tiles > self.residency
        return self.q8_route == "workspace" and self.m_tiles > 1

    @property
    def q8_waiters(self) -> int:
        """The CTAs of an M tile that wait for its rows' max and quantize
        it: all its N tiles on the resident route; on the workspace route
        its last Q8_WAITERS arrivals (fewer than the card keeps resident,
        so the wait cannot hang)."""
        if self.q8_route == "workspace":
            return min(self.n_tiles, Q8_WAITERS, self.residency)
        return self.n_tiles

    def split_steps(self, s: int) -> Tuple[int, int]:
        """The K steps [first, last) split ``s`` walks (as the kernel)."""
        return (s * self.k_steps // self.splits,
                (s + 1) * self.k_steps // self.splits)


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int, K: int, *, splits: Optional[int] = None,
         residency: Optional[int] = None,
         route: Optional[str] = None, bm: Optional[int] = None,
         experts: int = 1) -> GemmPlan:
    """The tiles and splits of one GEMM call (cached: the wrappers plan
    every call, and the serving loop is bound by the host); ``experts`` E
    for an expert-batched call, M rows an expert. ``splits``
    forces S (the wrappers' private ``_splits``, to sweep the reduction); it
    must lie in [1, max_splits]. ``residency`` (the quantize-out kernel's
    resident clusters at this tile and S) sets ``q8_route``; ``route``
    forces it (the wrappers' private ``_route``): ``"workspace"`` always
    may be taken, ``"resident"`` only where the residency allows it.
    ``bm`` forces the tile (``TILES``; the quantize-out plan's choice,
    ``q8_plan``)."""
    if experts < 1 or (experts > 1 and residency is not None):
        raise ValueError(f"experts={experts}: an expert-batched GEMM is 1 or "
                         f"more experts, and has no quantize-out route")
    if bm is None:
        bm = 16 if M <= 16 else 64 if M <= 256 else 128
    elif bm not in TILES:
        raise ValueError(f"bm={bm}: the tiles are {tuple(TILES)}")
    m_tiles, n_tiles = _cdiv(M, bm), _cdiv(N, TILES[bm])
    k_steps = _cdiv(K, BK)
    top = max_splits(k_steps)
    if splits is None:
        splits = min(_cdiv(k_steps, MAX_STEPS), top,
                     max(1, MAX_CTAS // (experts * m_tiles * n_tiles)))
    elif not 1 <= splits <= top:
        raise ValueError(f"splits={splits} outside [1, {top}] for K={K} "
                         f"({k_steps} steps of {BK}, at least {MIN_STEPS} a "
                         f"split, at most {MAX_SPLITS} splits)")
    q8_route = None
    if route is not None and route not in Q8_ROUTES:
        raise ValueError(f"route={route!r}: the routes are {Q8_ROUTES}")
    if residency is not None:
        tiles = m_tiles * n_tiles
        q8_route = route or ("resident" if tiles <= residency else "workspace")
        if q8_route == "resident" and n_tiles > residency:
            raise ValueError(
                f"route='resident' at M={M} N={N} K={K}: {n_tiles} N tiles "
                f"an M tile, but the card keeps {residency} resident — the "
                f"wait could hang")
        if q8_route == "workspace" and residency < 2:
            raise ValueError(f"residency={residency}: the workspace route "
                             f"needs two resident clusters")
    elif route is not None:
        raise ValueError("route needs the card's residency")
    return GemmPlan(M, N, K, bm, m_tiles, n_tiles, k_steps, splits,
                    residency, q8_route, experts)


def q8_plan(M: int, N: int, K: int, residency: Callable[[int, int], int], *,
            splits: Optional[int] = None, route: Optional[str] = None,
            wider: bool = True) -> GemmPlan:
    """The quantize-out GEMM's plan, ``residency(bm, splits)`` being the
    card's resident clusters of its kernel at that tile: the default tile's
    plan, unless it takes the workspace route and (``wider``) a wider tile's
    launch is resident at once (a prefill chunk's gate/up: 608 tiles of
    64 x 32 against 528 resident, 152 of 128 x 64 against 264). Only the
    W8A8 GEMM widens: its integer sums are exact in any tile, while the
    W8A16 GEMM's float32 sums follow the tile's warp groups, and its y must
    be the plain GEMM's. A resident launch by ticket loses more to the slots
    its waiting CTAs hold than the workspace costs (4096^3 on an H100:
    chip_smoke.py's qmatmul_w8a8_q8 line times both), so only ``route``
    forces it."""
    p = plan(M, N, K, splits=splits)
    p = plan(M, N, K, splits=p.splits, route=route,
             residency=residency(p.bm, p.splits))
    if route is None and wider and p.q8_route == "workspace":
        for bm in (b for b in TILES if b > p.bm):
            w = plan(M, N, K, splits=splits, bm=bm)
            w = plan(M, N, K, splits=w.splits, bm=bm,
                     residency=residency(bm, w.splits))
            if w.q8_route == "resident":
                return w
    return p
