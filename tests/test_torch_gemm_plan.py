"""The split-K planner both GEMM wrappers share (``kernels/gemm_plan.py``).

CPU only: the plan is plain integer arithmetic, and the CUDA kernels
(``csrc/gemm_mainloop.cuh``) walk exactly the K steps it describes. The
tests check that the splits tile K in whole BK steps, that the rule's bounds
hold (no CTA walks more than MAX_STEPS steps wherever the caps allow it),
that forced splits are validated, and that the planner's tile constants are
the kernel header's.
"""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import gemm_plan

# every K x N of the serving path (q/o, k/v, gate/up, down), then ragged K:
# below one step, one step plus one, and K not a multiple of S * BK
PATH_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
RAGGED_KN = [(33, 64), (65, 48), (4100, 70), (1000, 130), (2100, 100)]
MS = [1, 8, 17, 64, 256, 4096]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("K,N", PATH_KN + RAGGED_KN)
def test_splits_cover_k_in_whole_steps(M, K, N):
    p = gemm_plan.plan(M, N, K)
    assert p.k_steps == -(-K // gemm_plan.BK)
    assert p.k_steps * gemm_plan.BK >= K > (p.k_steps - 1) * gemm_plan.BK
    ranges = [p.split_steps(s) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == p.k_steps
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                                 # contiguous
    for a0, a1 in ranges:
        assert a1 - a0 >= 1                             # none empty
        if p.splits > 1:
            assert a1 - a0 >= gemm_plan.MIN_STEPS


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("K,N", PATH_KN + RAGGED_KN)
def test_split_rule(M, K, N):
    """S is the smallest split that leaves no CTA more than MAX_STEPS K
    steps, unless the caps (MIN_STEPS a split, MAX_SPLITS a cluster,
    MAX_CTAS a grid) stop it; the tiles cover M and N."""
    p = gemm_plan.plan(M, N, K)
    top = gemm_plan.max_splits(p.k_steps)
    assert 1 <= p.splits <= top <= gemm_plan.MAX_SPLITS
    assert p.splits == 1 or p.ctas <= gemm_plan.MAX_CTAS
    longest = max(b - a for a, b in map(p.split_steps, range(p.splits)))
    if p.splits < min(top, gemm_plan.MAX_CTAS // p.tiles):
        assert longest <= gemm_plan.MAX_STEPS
    if p.splits > 1:
        fewer = -(-p.k_steps // (p.splits - 1))
        assert fewer > gemm_plan.MAX_STEPS              # the smallest such S
    assert p.bm == (16 if M <= 16 else 64 if M <= 256 else 128)
    bn = gemm_plan.TILES[p.bm]
    assert p.m_tiles * p.bm >= M > (p.m_tiles - 1) * p.bm
    assert p.n_tiles * bn >= N > (p.n_tiles - 1) * bn
    assert p.ctas == p.m_tiles * p.n_tiles * p.splits


@pytest.mark.parametrize("K", [1, 33, 64])
def test_one_split_when_k_fits_one_step(K):
    for M in MS:
        assert gemm_plan.plan(M, 896, K).splits == 1


def test_path_plans():
    """The serving path's shapes: only the down projection (K = 4864, 76
    steps) is split, in 4 (19 steps a CTA); the decode grids."""
    for M in (8, 256):
        for K, N in PATH_KN:
            p = gemm_plan.plan(M, N, K)
            assert p.splits == (4 if K == 4864 else 1), (M, K, N)
    assert gemm_plan.plan(8, 4864, 896).ctas == 304
    assert gemm_plan.plan(8, 896, 4864).ctas == 56 * 4
    # the JAX bench's 4096^3: 2048 tiles of 128 x 64 already fill the card
    assert gemm_plan.plan(4096, 4096, 4096).splits == 1


@pytest.mark.parametrize("K,N", PATH_KN + RAGGED_KN)
def test_forced_splits(K, N):
    top = gemm_plan.max_splits(-(-K // gemm_plan.BK))
    for s in range(1, top + 1):
        p = gemm_plan.plan(8, N, K, splits=s)
        assert (p.bm, p.splits) == (16, s)
    for bad in (0, top + 1):
        with pytest.raises(ValueError, match="splits"):
            gemm_plan.plan(8, N, K, splits=bad)


def _header():
    path = (Path(gemm_plan.__file__).resolve().parents[1] / "csrc"
            / "gemm_mainloop.cuh")
    return path.read_text()


def test_constants_match_the_kernel_header():
    """The planner and gemm_mainloop.cuh agree on BK, the cluster cap and
    each tile's BN: the kernel derives the grid and each split's K steps
    from them."""
    text = _header()
    assert int(re.search(r"constexpr int BK = (\d+);", text)[1]) == gemm_plan.BK
    assert int(re.search(r"constexpr int MAX_SPLITS = (\d+);", text)[1]) \
        == gemm_plan.MAX_SPLITS
    for bm, bn in gemm_plan.TILES.items():
        m = re.search(r"struct Tile<%d> \{\s*static constexpr int BN = (\d+),"
                      % bm, text)
        assert m is not None and int(m[1]) == bn, bm
