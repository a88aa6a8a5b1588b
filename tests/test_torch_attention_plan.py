"""The split-S planner of decode attention (``kernels/attention_plan.py``)
and the plain version of the kernel's split-S scheme
(``kv_attention_split_ref``), on the CPU.

The plan is plain integer arithmetic, and the CUDA kernel
(``csrc/decode_attention.cuh``) walks exactly the tiles it describes: the
tests check that the splits tile [0, S) once, in whole tiles, none empty;
that a cluster holds at most 16 CTAs; that the rule (fill the card, keep a
tile a split) holds; that a CTA fits the H100's 227 KB; and that the
planner's constants are the header's.

The plain split-S version — per split a softmax state (m, l, acc, e), then
the splits combined in rank order — is held against the JAX package's
``kv_attention_ref`` and its serving op ``kv_attention_xla`` (with
``v_err`` against ``kv_attention_xla(v_err=...)``), on inputs made with
numpy from a seed, within float32 atol 1e-6 + rtol 1e-5 (the tolerance of
``test_torch_kv_attention.py``'s op test; the sums run in other orders):
at every shape of ``chip_smoke.py``'s ``KV_CASES`` (the long context with B
cut from 8 to 1, to keep the CPU's memory small), at every split count the
planner allows for the small ones, with a fully masked row (exactly 0 in
both) and a row of length 1 (every split but the first masked).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.kv_attention.ref import kv_attention_ref as jax_kv_ref
from repro.kernels.kv_attention.ref import kv_attention_xla

from repro_torch.kernels import attention_plan as ap
from repro_torch.kernels.kv_attention import (
    kv_attention_ref,
    kv_attention_split_ref,
)

# chip_smoke.py's KV_CASES: (B, Hq, Hkv, hd, S), the long context's B cut
KV_CASES = {
    "main-decode": (8, 14, 2, 64, 512),
    "S33": (4, 14, 2, 64, 33),
    "S-below-blk": (4, 14, 2, 64, 100),
    "gqa4": (4, 8, 2, 64, 300),
    "long-context-B1": (1, 32, 8, 128, 32768),
}
# shapes the planner must take beyond those: one tile, ragged S, MHA, a
# large group, B = 1 and a large batch
PLAN_SHAPES = list(KV_CASES.values()) + [
    (1, 4, 4, 16, 1), (3, 4, 2, 16, 65), (2, 8, 8, 128, 4096),
    (1, 64, 4, 64, 2048), (64, 14, 2, 64, 512), (8, 32, 8, 128, 32768),
    (1, 14, 2, 64, 100000),
]


@pytest.mark.parametrize("with_err", [False, True], ids=["plain", "v_err"])
@pytest.mark.parametrize("B,Hq,Hkv,hd,S", PLAN_SHAPES)
def test_splits_cover_s_once_in_whole_tiles(B, Hq, Hkv, hd, S, with_err):
    for splits in (None, 1, ap.max_splits(-(-S // ap.TS))):
        p = ap.plan(B, S, Hq, Hkv, hd, with_err, splits=splits)
        assert p.tiles == -(-S // ap.TS)
        assert 1 <= p.splits <= min(p.tiles, ap.MAX_SPLITS)
        spans = [p.split_positions(s) for s in range(p.splits)]
        assert spans[0][0] == 0 and spans[-1][1] == S
        for (_, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 == b0                              # contiguous
        for s, (a0, a1) in enumerate(spans):
            t0, t1 = p.split_tiles(s)
            assert t1 > t0 and a1 > a0                   # none empty
            assert a0 == t0 * ap.TS                      # whole tiles
        assert p.smem == ap.smem_bytes(Hq // Hkv, hd, with_err)
        assert p.smem <= ap.MAX_SMEM
        assert p.ctas == B * Hkv * p.splits


@pytest.mark.parametrize("B,Hq,Hkv,hd,S", PLAN_SHAPES)
def test_split_rule(B, Hq, Hkv, hd, S):
    """The fewest splits that give the card TARGET_CTAS CTAs, unless a
    split would lose its last tile or the cluster its 16-CTA cap."""
    p = ap.plan(B, S, Hq, Hkv, hd)
    top = ap.max_splits(p.tiles)
    assert p.splits == top or p.ctas >= ap.TARGET_CTAS
    assert p.splits == 1 or B * Hkv * (p.splits - 1) < ap.TARGET_CTAS


def test_path_plans():
    """The serving decode shape takes one tile a CTA (8 splits, 128 CTAs);
    the JAX bench's long context 16 splits of 32 tiles (1,024 CTAs)."""
    main = ap.plan(8, 512, 14, 2, 64)
    assert (main.splits, main.ctas, main.split_tiles(0)) == (8, 128, (0, 1))
    long = ap.plan(8, 32768, 32, 8, 128)
    assert (long.splits, long.ctas, long.split_tiles(1)) == (16, 1024,
                                                             (32, 64))
    # the plan depends on B, S and Hkv alone: the fused and the unfused
    # decode (v_err or not) split alike
    assert ap.plan(8, 512, 14, 2, 64, True).splits == main.splits


@pytest.mark.parametrize("bad", [0, 9])
def test_forced_splits_outside_the_range_raise(bad):
    for s in range(1, 9):
        assert ap.plan(8, 512, 14, 2, 64, splits=s).splits == s
    with pytest.raises(ValueError, match="splits"):
        ap.plan(8, 512, 14, 2, 64, splits=bad)


@pytest.mark.parametrize("shape", [
    (8, 0, 14, 2, 64),        # no position
    (8, 512, 14, 4, 64),      # Hq not a multiple of Hkv
    (8, 512, 14, 2, 40),      # hd not a multiple of 16
    (1, 512, 128, 1, 256),    # 128 q heads x 256 dims: past 227 KB
])
def test_shapes_the_kernel_does_not_take_raise(shape):
    B, S, Hq, Hkv, hd = shape
    with pytest.raises(ValueError, match="decode attention"):
        ap.plan(B, S, Hq, Hkv, hd)


def test_constants_match_the_kernel_header():
    text = (Path(ap.__file__).resolve().parents[1] / "csrc"
            / "decode_attention.cuh").read_text()
    for name in ("TS", "THREADS", "STAGES", "ROW_PAD", "MAX_SPLITS"):
        m = re.search(r"constexpr int %s = (\d+);" % name, text)
        assert m is not None and int(m[1]) == getattr(ap, name), name
    m = re.search(r"MAX_SMEM = (\d+) \* 1024;", text)
    assert int(m[1]) * 1024 == ap.MAX_SMEM


def _inputs(B, Hq, Hkv, hd, S, seed=0):
    """numpy q, K/V payload and scales (zero past each row's length: row 0
    full, row 1 of length 1, the last row fully masked when B > 2) and V
    error means zero where the scales are, as the decode route passes
    them."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hq, hd).astype(np.float32)
    kq = rng.randint(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    vq = rng.randint(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    ks = (rng.rand(B, S, Hkv) * 0.02).astype(np.float32)
    vs = (rng.rand(B, S, Hkv) * 0.02).astype(np.float32)
    lens = rng.randint(1, S + 1, B)
    lens[0] = S
    if B > 1:
        lens[1] = 1
    if B > 2:
        lens[-1] = 0
    live = (np.arange(S)[None, :] < lens[:, None])[..., None]
    ks, vs = ks * live, vs * live
    verr = (rng.randn(B, S, Hkv) * 1e-3).astype(np.float32) * live
    return q, kq, ks, vq, vs, verr


def _splits(B, Hq, Hkv, hd, S):
    """Every split count at the small shapes, the plan's at the long one."""
    p = ap.plan(B, S, Hq, Hkv, hd)
    if S > 4096:
        return [p.splits]
    return list(range(1, ap.max_splits(p.tiles) + 1))


@pytest.mark.parametrize("with_err", [False, True], ids=["plain", "v_err"])
@pytest.mark.parametrize("case", list(KV_CASES))
def test_split_version_matches_jax(case, with_err):
    """Against JAX ``kv_attention_ref`` (no v_err: it has none) and JAX
    ``kv_attention_xla`` (with and without v_err), at every split count."""
    B, Hq, Hkv, hd, S = KV_CASES[case]
    q, kq, ks, vq, vs, verr = _inputs(B, Hq, Hkv, hd, S)
    ve = verr if with_err else None
    jargs = list(map(jnp.asarray, (q, kq, ks, vq, vs)))
    want_op = np.asarray(kv_attention_xla(
        *jargs, v_err=None if ve is None else jnp.asarray(ve)))
    want_ref = None if with_err else np.asarray(jax_kv_ref(*jargs, blk=512))
    targs = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs)]
    for splits in _splits(B, Hq, Hkv, hd, S):
        got = kv_attention_split_ref(
            *targs, splits=splits,
            v_err=None if ve is None else torch.from_numpy(ve)).numpy()
        np.testing.assert_allclose(got, want_op, rtol=1e-5, atol=1e-6,
                                   err_msg=f"splits={splits}")
        if want_ref is not None:
            np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6,
                                       err_msg=f"splits={splits}")
        if B > 2:
            assert not got[-1].any() and not want_op[-1].any()


@pytest.mark.parametrize("with_err", [False, True], ids=["plain", "v_err"])
def test_masked_splits_add_nothing(with_err):
    """A row of length 1 at S = 512: all but the first of the 8 splits are
    masked (m = -1e30) and add exactly nothing, so every split count gives
    the unsplit walk's state; a row with nothing live and its V error means
    nonzero gives -sum(v_err) / l, the value the blocked oracle pins
    (l counting every padded position, as one block of 512 does)."""
    B, Hq, Hkv, hd, S = 3, 4, 2, 16, 512
    q, kq, ks, vq, vs, verr = _inputs(B, Hq, Hkv, hd, S)
    args = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs)]
    ve = torch.from_numpy(verr) if with_err else None
    one = kv_attention_split_ref(*args, splits=1, v_err=ve)
    for splits in range(2, 9):
        got = kv_attention_split_ref(*args, splits=splits, v_err=ve)
        # row 1 (length 1): the first split holds its one live position
        torch.testing.assert_close(got[1], one[1], rtol=1e-6, atol=0)
        assert not got[2].any()                        # fully masked row
    if with_err:
        ve_all = torch.randn((B, S, Hkv), generator=torch.Generator()
                             .manual_seed(0)) * 1e-3
        zero = [torch.zeros_like(t) for t in (args[2], args[4])]
        masked = (args[0], args[1], zero[0], args[3], zero[1])
        want = kv_attention_ref(*masked, blk=512, v_err=ve_all)
        for splits in (1, 4, 8):
            got = kv_attention_split_ref(*masked, splits=splits,
                                         v_err=ve_all)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)
