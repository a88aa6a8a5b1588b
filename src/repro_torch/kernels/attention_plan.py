"""The split-S planner both decode attention wrappers share
(``csrc/decode_attention.cuh``).

A decode attention call attends, for each batch row b and kv head g, over
the S cache positions. The kernel walks S in tiles of ``TS`` positions and
splits the tiles across CTAs (flash-decoding): the grid is
splits x Hkv x B, split s of (b, g) walks the tiles
``[s * tiles // splits, (s + 1) * tiles // splits)`` for g's ``group`` q
heads, and the splits of one (b, g) are one thread block cluster whose rank
0 combines them through distributed shared memory in the same launch.

The split count fills the H100's 132 SMs without taking a CTA below one
tile of work, and a cluster holds at most ``MAX_SPLITS`` CTAs: S is the
fewest splits that give the grid ``TARGET_CTAS`` CTAs (eight a SM), capped
at one tile a split and 16 a cluster. Past one wave the splits still pay:
chip_smoke.py's attention split sweep at the JAX bench's long context
(64 (b, kv head) pairs, three 67 KB CTAs resident a SM) gains at every
step up to 16 splits, as smaller shares balance the SMs; at the serving
decode shape the cap of one tile a split (8 splits, 128 CTAs) binds first. It depends only on B, S and Hkv, so the fused and the
unfused decode plan every call alike and give the same bits. A CTA's shared
memory depends only on the group, hd and whether ``v_err`` is carried; a
shape past the card's 227 KB is refused here, before any launch.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

TS = 64           # cache positions a tile (attn::TS)
THREADS = 256     # threads a CTA (attn::THREADS)
STAGES = 3        # tiles in the cp.async ring (attn::STAGES)
ROW_PAD = 16      # bytes after each staged payload row (attn::ROW_PAD)
VALID_BYTES = TS + 16  # bytes of the live mask a stage holds (attn::VALID_BYTES)
MAX_SPLITS = 16   # CTAs in a cluster (attn::MAX_SPLITS; H100, non-portable)
SMS = 132         # the H100's streaming multiprocessors
TARGET_CTAS = 8 * SMS  # splits stop growing once the grid holds this many
MAX_SMEM = 227 * 1024  # dynamic shared memory a CTA may use on the H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(group: int, hd: int, with_err: bool) -> int:
    """A CTA's dynamic shared memory, as ``attn::smem_bytes``: q and acc
    for ``group`` heads, a score tile, the effective scales, the softmax
    state, the combine factors, the value pass's partial sums and the
    fused decode's new token in float32, then ``STAGES`` ring stages of two int8 payload tiles and
    their scales and live-mask bytes — or, if larger, the ``MAX_SPLITS`` boxes in which the
    splits' states meet for the combine (they reuse the ring)."""
    floats = (2 * group * hd + group * TS + 3 * TS + 4 * group
              + MAX_SPLITS * group + 32 + 4 * THREADS + 2 + hd // 2)
    fixed = _cdiv(4 * floats, 16) * 16
    stage = (2 * TS * (hd + ROW_PAD) + (3 if with_err else 2) * TS * 4
             + VALID_BYTES)
    boxes = MAX_SPLITS * (group * hd + 4 * group) * 4
    return fixed + max(STAGES * stage, boxes)


def max_splits(tiles: int) -> int:
    """The most splits that keep a tile each and fit a cluster."""
    return max(1, min(tiles, MAX_SPLITS))


@dataclass(frozen=True)
class AttentionPlan:
    B: int
    S: int
    Hq: int
    Hkv: int
    hd: int
    with_err: bool
    tiles: int      # ceil(S / TS)
    splits: int     # CTAs of a cluster, one cluster per (b, kv head)
    smem: int       # dynamic shared memory a CTA, bytes

    @property
    def group(self) -> int:
        return self.Hq // self.Hkv

    @property
    def ctas(self) -> int:
        return self.B * self.Hkv * self.splits

    def split_tiles(self, s: int) -> Tuple[int, int]:
        """The tiles [first, last) split ``s`` walks (as the kernel)."""
        return (s * self.tiles // self.splits,
                (s + 1) * self.tiles // self.splits)

    def split_positions(self, s: int) -> Tuple[int, int]:
        """The cache positions [first, last) split ``s`` attends over."""
        a, b = self.split_tiles(s)
        return min(a * TS, self.S), min(b * TS, self.S)


@functools.lru_cache(maxsize=1024)
def plan(B: int, S: int, Hq: int, Hkv: int, hd: int, with_err: bool = False,
         *, splits: Optional[int] = None) -> AttentionPlan:
    """The split of one decode attention call (cached: the wrappers plan
    every call, and the serving loop is bound by the host). ``splits``
    forces the split count (the wrappers' private ``_splits``, to sweep it
    on the card); it must lie in [1, max_splits(tiles)]. Raises on a shape
    the kernel does not take."""
    if S < 1 or Hkv < 1 or Hq % Hkv or hd < 16 or hd % 16:
        raise ValueError(
            f"decode attention takes S >= 1, Hq a multiple of Hkv and hd a "
            f"multiple of 16 (16-byte payload copies), got S={S} Hq={Hq} "
            f"Hkv={Hkv} hd={hd}")
    tiles = _cdiv(S, TS)
    top = max_splits(tiles)
    if splits is None:
        splits = min(top, max(1, _cdiv(TARGET_CTAS, max(1, B * Hkv))))
    elif not 1 <= splits <= top:
        raise ValueError(f"splits={splits} outside [1, {top}] for S={S} "
                         f"({tiles} tiles of {TS}, at least one a split, at "
                         f"most {MAX_SPLITS} splits)")
    smem = smem_bytes(Hq // Hkv, hd, with_err)
    if smem > MAX_SMEM:
        raise ValueError(
            f"decode attention: group {Hq // Hkv} x hd {hd} needs {smem} "
            f"bytes of shared memory a CTA, more than the {MAX_SMEM} an H100 "
            f"CTA may use")
    return AttentionPlan(B, S, Hq, Hkv, hd, bool(with_err), tiles, splits,
                         smem)
