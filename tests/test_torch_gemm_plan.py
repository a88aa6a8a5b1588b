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


# ------------------------------------------------- the quantize-in fold

@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("K,N", PATH_KN)
def test_fold_at_every_decode_path_shape(M, K, N):
    """Every decode tile of the serving path quantizes its own A: the slice
    fits beside the ring, and a W8A8 decode step launches no quantize_act."""
    p = gemm_plan.plan(M, N, K)
    assert p.bm == 16 and p.qin_fits and p.fold


@pytest.mark.parametrize("K,N", PATH_KN)
def test_no_fold_at_a_prefill_chunk(K, N):
    """A prefill chunk (8 slots x 32 = 256 rows, 64-row tiles) keeps one
    quantize_act launch for the GEMMs that read its activation, though the
    fold would fit."""
    p = gemm_plan.plan(256, N, K)
    assert p.bm == 64 and p.qin_fits and not p.fold


def test_fold_refused_where_shared_memory_runs_out():
    """The slice is bm x the longest split's K steps x BK bytes beside the
    W ring: over QIN_SMEM_MAX the plan refuses the fold (the wrapper then
    raises rather than launch)."""
    p = gemm_plan.plan(64, 896, 4864, splits=1)         # 64 x 4864 bytes
    assert p.qin_smem == 2 * 4 * 32 * 64 + 64 * 76 * 64 > gemm_plan.QIN_SMEM_MAX
    assert not p.qin_fits and not p.fold
    p = gemm_plan.plan(8, 8, 1 << 18)                   # 16 splits still too long
    assert p.splits == gemm_plan.MAX_SPLITS and not p.qin_fits and not p.fold
    assert gemm_plan.plan(8, 4864, 896).qin_smem == 8 * 3 * 16 * 64 + 16 * 14 * 64
    assert gemm_plan.plan(8, 896, 4864).qin_smem == 8 * 3 * 16 * 64 + 16 * 19 * 64


@pytest.mark.parametrize("K,N", PATH_KN + RAGGED_KN)
def test_forced_splits_keep_the_fold_valid(K, N):
    """At the decode tile every forced split still fits and folds; the
    slice shrinks as the splits grow, and the cluster (share N tiles x the
    splits) never outgrows MAX_SPLITS, each part keeping a K step."""
    top = gemm_plan.max_splits(-(-K // gemm_plan.BK))
    smem = []
    for s in range(1, top + 1):
        p = gemm_plan.plan(8, N, K, splits=s)
        assert p.fold and p.qin_fits
        assert p.share * p.splits <= gemm_plan.MAX_SPLITS
        assert 1 <= p.share <= min(gemm_plan.MAX_SHARE, p.n_tiles)
        assert p.share & (p.share - 1) == 0
        assert p.share <= p.k_steps // p.splits or p.share == 1
        smem.append(p.qin_smem)
    assert smem == sorted(smem, reverse=True)


def test_share_at_the_path_shapes():
    """q/o, k/v and gate/up: eight N tiles share the quantizing of A; the
    down projection's 4 splits leave room for 4 (16-CTA clusters)."""
    for K, N in PATH_KN:
        p = gemm_plan.plan(8, N, K)
        assert (p.share, p.share * p.splits) == ((4, 16) if K == 4864 else (8, 8))


def test_qin_constants_match_the_kernel_sources():
    """The planner's ring geometry (GROUPS, STAGES) is gemm_mainloop.cuh's
    Tile<BM>, and QIN_SMEM_MAX is qmatmul_w8a8.cu's: the wrapper refuses
    exactly the calls the kernel would."""
    text = _header()
    for bm in gemm_plan.TILES:
        m = re.search(r"struct Tile<%d> \{\s*static constexpr int BN = \d+, "
                      r"WM = \d+, WN = \d+, GROUPS = (\d+);\s*static "
                      r"constexpr int STAGES = (\d+)," % bm, text)
        assert m is not None, bm
        assert (int(m[1]), int(m[2])) == (gemm_plan.GROUPS[bm],
                                          gemm_plan.STAGES[bm])
    src = (Path(gemm_plan.__file__).resolve().parents[1] / "csrc"
           / "qmatmul_w8a8.cu").read_text()
    m = re.search(r"constexpr int QIN_SMEM_MAX = (\d+) \* 1024;", src)
    assert int(m[1]) * 1024 == gemm_plan.QIN_SMEM_MAX


# ------------------------------------------------- the quantize-out route

def _residency(per_tile):
    """A card's resident clusters of the quantize-out kernel, given by the
    test: ``per_tile[bm]`` CTAs at one split, that many over S in clusters
    of S."""
    return lambda bm, splits: per_tile[bm] // splits


# an H100's W8A8 quantize-out kernels (4, 4 and 2 CTAs an SM on 132 SMs)
H100ISH = _residency({16: 528, 64: 528, 128: 264})


@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("K,N", PATH_KN)
def test_q8_route_at_the_path_shapes(M, K, N):
    """Every path shape takes the resident route with every tile resident
    at once (no tickets): the default tile, but the prefill chunk's gate/up,
    whose 608 tiles of 64 x 32 outnumber the residency, takes 128 x 64."""
    p = gemm_plan.q8_plan(M, N, K, H100ISH)
    assert p.q8_route == "resident" and not p.q8_ticketed
    assert p.tiles <= p.residency and p.q8_waiters == p.n_tiles
    wide = (M, K, N) == (256, 896, 4864)
    assert p.bm == (128 if wide else gemm_plan.plan(M, N, K).bm)
    assert p.splits == gemm_plan.plan(M, N, K, bm=p.bm).splits


def test_q8_route_at_the_jax_bench_shape():
    """4096^3: 2,048 tiles of 128 x 64 outnumber every tile's residency, so
    the workspace route, by ticket (32 M tiles), the last Q8_WAITERS of an
    M tile's 64 N tiles quantizing it; the resident route by ticket may
    still be forced."""
    p = gemm_plan.q8_plan(4096, 4096, 4096, H100ISH)
    assert (p.bm, p.q8_route, p.q8_ticketed, p.q8_waiters) == \
        (128, "workspace", True, gemm_plan.Q8_WAITERS)
    forced = gemm_plan.q8_plan(4096, 4096, 4096, H100ISH, route="resident")
    assert forced.q8_route == "resident" and forced.q8_ticketed


@pytest.mark.parametrize("residency,route,waiters", [
    (528, "workspace", gemm_plan.Q8_WAITERS), (10_000, "resident", 9496)])
def test_q8_route_at_the_vocabulary(residency, route, waiters):
    """qwen2's vocabulary at a decode step: 9,496 N tiles. Above the card's
    residency the workspace route, its last Q8_WAITERS CTAs quantizing;
    with a residency given that holds them all, the resident route."""
    p = gemm_plan.q8_plan(8, 151936, 896, lambda bm, s: residency)
    assert p.n_tiles == 9496 and p.m_tiles == 1
    assert (p.q8_route, p.q8_waiters, p.q8_ticketed) == (route, waiters, False)
    assert f"q8_route='{route}'" in repr(p)


@pytest.mark.parametrize("M,K,N", [(8, 896, 4864), (256, 896, 4864),
                                   (4096, 4096, 4096), (8, 896, 151936),
                                   (70, 96, 130), (3, 4100, 70), (1, 16, 8)])
@pytest.mark.parametrize("per_tile", [2, 16, 528])
def test_q8_waiters_never_hang_and_never_alone(M, K, N, per_tile):
    """Whatever the residency: an M tile's waiting CTAs are fewer than the
    card keeps resident where the tiles outnumber it (the no-hang bound),
    and more than one share the M tile's rows wherever it has two N
    tiles."""
    p = gemm_plan.q8_plan(M, N, K, lambda bm, s: per_tile)
    assert 1 <= p.q8_waiters <= p.n_tiles
    assert p.q8_waiters <= p.residency
    if p.n_tiles >= 2:
        assert p.q8_waiters >= 2
    if p.q8_route == "resident" and p.q8_ticketed:
        assert p.n_tiles <= p.residency


def test_q8_route_forcing_and_refusals():
    """``route`` forces the route: the workspace route always, the resident
    route only where an M tile's N tiles fit; a route needs the residency,
    and the tile must be one of TILES."""
    p = gemm_plan.plan(8, 4864, 896, residency=528, route="workspace")
    assert p.q8_route == "workspace" and p.q8_waiters == gemm_plan.Q8_WAITERS
    assert gemm_plan.plan(8, 4864, 896, residency=528).q8_route == "resident"
    with pytest.raises(ValueError, match="hang"):
        gemm_plan.plan(8, 151936, 896, residency=528, route="resident")
    with pytest.raises(ValueError, match="residency"):
        gemm_plan.plan(8, 4864, 896, route="workspace")
    with pytest.raises(ValueError, match="routes"):
        gemm_plan.plan(8, 4864, 896, residency=528, route="cluster")
    with pytest.raises(ValueError, match="tiles"):
        gemm_plan.plan(8, 4864, 896, bm=32)
    assert gemm_plan.plan(8, 4864, 896).q8_route is None


def test_q8_plan_keeps_the_tile_where_sums_are_float():
    """``wider=False`` (the W8A16 GEMM, whose float32 sums follow the
    tile's warp groups) keeps the plain GEMM's tile and splits: at the
    prefill chunk's gate/up the ticketed launch falls to the workspace
    route instead of the 128 x 64 tile."""
    p = gemm_plan.q8_plan(256, 4864, 896, H100ISH, wider=False)
    plain = gemm_plan.plan(256, 4864, 896)
    assert (p.bm, p.splits) == (plain.bm, plain.splits) == (64, 1)
    assert p.q8_route == "workspace" and p.q8_ticketed


# the MoE archs' expert-batched projections (E, M, K, N): mixtral's decode
# and prefill gate/up and down, llama4's, and a small ragged one
EXPERT_KN = [(8, 8, 6144, 16384), (8, 80, 6144, 16384), (8, 8, 16384, 6144),
             (8, 80, 16384, 6144), (16, 8, 5120, 8192), (16, 16, 8192, 5120),
             (4, 5, 4100, 70)]


@pytest.mark.parametrize("E,M,K,N", EXPERT_KN)
def test_experts_count_against_the_grid(E, M, K, N):
    """An expert-batched plan is one expert's tiles, E of them on the grid:
    K splits only while E x the tiles leave room under MAX_CTAS (at a
    mixtral decode step the gate/up's 8 x 1024 tiles fill the card
    unsplit), and the fold is the single plan's rule at that split."""
    p = gemm_plan.plan(M, N, K, experts=E)
    one = gemm_plan.plan(M, N, K)
    assert (p.bm, p.m_tiles, p.n_tiles, p.k_steps) == (
        one.bm, one.m_tiles, one.n_tiles, one.k_steps)
    assert p.experts == E and p.ctas == E * p.tiles * p.splits
    assert p.splits == 1 or p.ctas <= gemm_plan.MAX_CTAS
    assert p.splits == min(-(-p.k_steps // gemm_plan.MAX_STEPS),
                           gemm_plan.max_splits(p.k_steps),
                           max(1, gemm_plan.MAX_CTAS // (E * p.tiles)))
    assert p.fold == (p.bm in gemm_plan.FOLD_BM and p.qin_fits)
    with pytest.raises(ValueError, match="experts"):
        gemm_plan.plan(M, N, K, experts=0)


def test_mixtral_decode_gate_up_takes_no_split_and_folds():
    p = gemm_plan.plan(8, 16384, 6144, experts=8)
    assert (p.splits, p.ctas, p.fold) == (1, 8 * 1024, True)
    down = gemm_plan.plan(8, 6144, 16384, experts=8)
    assert down.splits == 1 and not down.fold     # a 256 KiB int8 slice


def _chip_smoke():
    """chip_smoke.py, loaded from the repo root (it imports torch only
    inside its functions)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_11_gemms_are_every_projection_of_the_new_families():
    """The shapes chip_smoke.py's phase 2 and the card tests hold against
    the plain versions for phase 11 (``family_gemms``, ``family_quantize``,
    derived from the layers phase 11 runs) are every GEMM of the three
    families at the published widths, written out here from the configs:
    at a decode step of 8 and a 128-token prefill of 8, mamba2's in_proj
    (2 x 5120 + 2 x 128 + 80 = 10576) and out_proj, zamba2's in_proj
    (2 x 5120 + 2 x 64 + 80 = 10448; its out_proj is mamba2's), its shared
    block's q/k/v/o (32 heads of 80), gate/up and down, whisper's decoder
    projections; whisper's encoder over 8 x 1500 frames. quantize_act
    runs at the prefill's and the encoder's inputs, every decode input
    folds."""
    cs = _chip_smoke()
    decode, prefill, enc = 8, 8 * 128, 8 * 1500
    want = {(enc, 384, 384), (enc, 384, 1536), (enc, 1536, 384)}
    for M in (decode, prefill):
        want |= {(M, 2560, 10576), (M, 5120, 2560), (M, 2560, 10448),
                 (M, 2560, 2560), (M, 2560, 10240), (M, 10240, 2560),
                 (M, 384, 384), (M, 384, 1536), (M, 1536, 384)}
    got = [(M, K, N) for _, K, N, ms in cs.family_gemms() for M in ms]
    assert len(got) == len(set(got)) and set(got) == want
    assert set(cs.family_quantize()) == {
        (prefill, 2560), (prefill, 5120), (prefill, 10240), (prefill, 384),
        (prefill, 1536), (enc, 384), (enc, 1536)}
