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
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

TILES = {16: 16, 64: 32, 128: 64}  # BM: BN (gemm_mainloop.cuh: Tile<BM>)
BK = 64           # K elements per ring step (gemm::BK)
MAX_STEPS = 24    # K steps a CTA walks at most, where K allows more splits
MIN_STEPS = 2     # K steps every split keeps at least
MAX_SPLITS = 16   # CTAs in a cluster (gemm::MAX_SPLITS; H100, non-portable)
MAX_CTAS = 4 * 132  # a split stops filling the H100's 132 SMs past this


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

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    def split_steps(self, s: int) -> Tuple[int, int]:
        """The K steps [first, last) split ``s`` walks (as the kernel)."""
        return (s * self.k_steps // self.splits,
                (s + 1) * self.k_steps // self.splits)


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int, K: int, *, splits: Optional[int] = None) -> GemmPlan:
    """The tiles and splits of one GEMM call (cached: the wrappers plan
    every call, and the serving loop is bound by the host). ``splits``
    forces S (the wrappers' private ``_splits``, to sweep the reduction); it
    must lie in [1, max_splits]."""
    bm = 16 if M <= 16 else 64 if M <= 256 else 128
    m_tiles, n_tiles = _cdiv(M, bm), _cdiv(N, TILES[bm])
    k_steps = _cdiv(K, BK)
    top = max_splits(k_steps)
    if splits is None:
        splits = min(_cdiv(k_steps, MAX_STEPS), top,
                     max(1, MAX_CTAS // (m_tiles * n_tiles)))
    elif not 1 <= splits <= top:
        raise ValueError(f"splits={splits} outside [1, {top}] for K={K} "
                         f"({k_steps} steps of {BK}, at least {MIN_STEPS} a "
                         f"split, at most {MAX_SPLITS} splits)")
    return GemmPlan(M, N, K, bm, m_tiles, n_tiles, k_steps, splits)
