"""The port's plain kernel versions against the JAX package's refs.

The same numpy inputs, made from a seed, go through the JAX function and its
``repro_torch`` counterpart on the CPU. Where the JAX op would reach Pallas,
its ``ref`` tier is called, as the JAX package's own tests do. Tolerances:

  * quantize_act, quantize_kv, append_quantize, quantize_param — bit-equal:
    the max is order-independent and division / round-half-even are IEEE in
    both frameworks.
  * qmatmul_w8a8 — the integer accumulator equal; the float32 output within
    1 ulp (the epilogue is the same three float32 operations in the same
    order; only the accumulator's route differs: int32 in JAX, float64 —
    exact here — in the port).
  * qmatmul_w8a16 — not bit-equal: both dequantize the weight in float32
    (bit-equal) and take the float32 product ``a @ w``, but XLA's and
    PyTorch's CPU products sum in different orders. Float32 output within
    ``K · 2⁻²³ · (|a| @ |w_deq|)`` (two sums of K products, each within
    K/2 · 2⁻²³ of the exact one); bfloat16 output within one bf16 ulp of
    the JAX value. The W8A8 GEMMs were exact in int32: this is the first
    GEMM on the serving path without bit-parity.
  * fused_decode — output within rtol 1e-5 / atol 1e-6 (float32 exp and
    einsum summation order differ between XLA and PyTorch), appended cache
    leaves bit-equal, quantize-out int8 off by at most 1 and only where the
    value sits at a rounding tie (|frac - 0.5| < 1e-3).

The kernel (CUDA) tier runs on the card only: ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.fused_decode.ops import fused_decode as jax_fused_decode
from repro.kernels.kv_attention.ops import append_quantize as jax_append
from repro.kernels.kv_attention.ops import quantize_kv as jax_quantize_kv
from repro.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_ref as jax_qmm_ref
from repro.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref as jax_w16_ref
from repro.kernels.quantize_act.ref import quantize_act_ref as jax_qact_ref
from repro.quantized.qtensor import quantize_param as jax_quantize_param

from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.fused_decode import fused_decode, fused_decode_ref
from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
from repro_torch.kernels.kv_attention import (
    append_quantize,
    kv_attention_ref,
    pad_to_block,
    quantize_kv,
)
from repro_torch.kernels.qmatmul_w8a8 import (
    qmatmul_w8a8,
    qmatmul_w8a8_acc,
    qmatmul_w8a8_ref,
)
from repro_torch.kernels.qmatmul_w8a8.kernel import qmatmul_w8a8_cuda
from repro_torch.kernels.qmatmul_w8a16 import (
    qmatmul_w8a16,
    qmatmul_w8a16_q8_ref,
    qmatmul_w8a16_ref,
)
from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref
from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda
from repro_torch.quantized.qtensor import quantize_param

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# ------------------------------------------------------------ quantize_act

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,seed", [((1, 5), 0), ((8, 64), 1),
                                        ((7, 129), 2), ((16, 896), 3)])
def test_quantize_act_ref_bit_equal(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
    x[0, : min(4, shape[1])] = [0.5, -1.5, 2.5, 0.0][: min(4, shape[1])]
    if shape[0] > 1:
        x[1] = 0.0                                   # all-zero row: floor scale
    xj, xt = _both(x, dtype)
    qj, sj = jax_qact_ref(xj)
    qt, st = quantize_act_ref(xt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


def test_quantize_act_op_on_cpu_is_the_plain_version():
    x = torch.from_numpy(np.random.RandomState(4).randn(6, 40).astype(np.float32))
    reset_launch_counts()
    q, s = quantize_act(x)
    qr, sr = quantize_act_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert launch_counts()["quantize_act"] == 0   # no kernel on the CPU


# ------------------------------------------------------------ qmatmul_w8a8

QMM_CASES = [  # (M, K, N, per_row_scale, bias)
    (1, 16, 8, True, True),
    (8, 64, 128, True, True),
    (5, 33, 17, False, True),       # ragged K and N, per-tensor scales
    (64, 96, 40, True, False),
    (3, 4864 // 38, 896 // 7, True, True),
]


def _qmm_inputs(M, K, N, per_row, with_bias, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-128, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    sa = (rng.rand(M if per_row else 1) * 0.05 + 1e-4).astype(np.float32)
    sw = (rng.rand(N if per_row else 1) * 0.01 + 1e-4).astype(np.float32)
    bias = rng.randn(N).astype(np.float32) if with_bias else None
    return a, w, sa, sw, bias


@pytest.mark.parametrize("case", QMM_CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_qmatmul_w8a8_accumulator_exact(case):
    M, K, N, per_row, with_bias = case
    a, w, *_ = _qmm_inputs(M, K, N, per_row, with_bias, seed=M + K)
    acc_np = a.astype(np.int64) @ w.astype(np.int64)
    acc_jax = np.asarray(jnp.matmul(jnp.asarray(a, jnp.int32),
                                    jnp.asarray(w, jnp.int32)))
    acc_t = qmatmul_w8a8_acc(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(acc_t.numpy().astype(np.int64), acc_np)
    np.testing.assert_array_equal(acc_jax, acc_np)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QMM_CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_qmatmul_w8a8_ref_vs_jax(case, out):
    M, K, N, per_row, with_bias = case
    a, w, sa, sw, bias = _qmm_inputs(M, K, N, per_row, with_bias, seed=M * K)
    jd, td = DTYPES[out]
    sa_b = np.broadcast_to(sa, (M,)).copy()
    sw_b = np.broadcast_to(sw, (N,)).copy()
    yj = np.asarray(jax_qmm_ref(jnp.asarray(a), jnp.asarray(w),
                                jnp.asarray(sa_b), jnp.asarray(sw_b),
                                None if bias is None else jnp.asarray(bias),
                                jd).astype(jnp.float32))
    yt = qmatmul_w8a8_ref(torch.from_numpy(a), torch.from_numpy(w),
                          torch.from_numpy(sa_b), torch.from_numpy(sw_b),
                          None if bias is None else torch.from_numpy(bias),
                          td).float().numpy()
    ulp = np.spacing(np.abs(yj).astype(np.float32))
    if out == "bfloat16":
        ulp = ulp * 2 ** 16                       # a bf16 ulp of the value
    assert np.all(np.abs(yt - yj) <= ulp), np.max(np.abs(yt - yj) / ulp)
    # and through the public op, on a K-major weight as QTensor stores it
    w_km = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    y_op = qmatmul_w8a8(torch.from_numpy(a), w_km, torch.from_numpy(sa),
                        torch.from_numpy(sw),
                        None if bias is None else torch.from_numpy(bias),
                        out_dtype=td).float().numpy()
    np.testing.assert_array_equal(y_op, yt)


# ------------------------------------------------------------ qmatmul_w8a16

W16_CASES = [  # (M, K, N, per_channel_scale, bias)
    (1, 16, 8, True, True),
    (8, 64, 128, False, True),      # decode rows, per-tensor [1] scale
    (5, 33, 17, True, True),        # ragged M, K and N
    (64, 96, 40, True, False),
    (256, 64, 32, False, False),    # a prefill chunk's rows
    (3, 4864 // 38, 896 // 7, False, True),
]


def _w16_inputs(M, K, N, per_channel, with_bias, seed):
    rng = np.random.RandomState(seed)
    a = (rng.randn(M, K) * rng.choice([0.1, 1.0, 4.0])).astype(np.float32)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    sw = (rng.rand(N if per_channel else 1) * 0.01 + 1e-4).astype(np.float32)
    bias = rng.randn(N).astype(np.float32) if with_bias else None
    return a, w, sw, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", W16_CASES,
                         ids=lambda c: "x".join(map(str, c[:3]))
                         + ("-pc" if c[3] else "-pt") + ("-b" if c[4] else ""))
def test_qmatmul_w8a16_ref_vs_jax(case, dtype):
    M, K, N, per_channel, with_bias = case
    a, w, sw, bias = _w16_inputs(M, K, N, per_channel, with_bias,
                                 seed=M + K + N)
    aj, at = _both(a, dtype)
    jd, td = DTYPES[dtype]
    yj = np.asarray(jax_w16_ref(aj, jnp.asarray(w), jnp.asarray(sw),
                                None if bias is None else jnp.asarray(bias),
                                jd).astype(jnp.float32))
    # on the weight as given and on the K-major storage QTensor keeps (the
    # CPU product sums in another order for a transposed operand)
    w_km = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    bias_t = None if bias is None else torch.from_numpy(bias)
    if dtype == "float32":
        w_deq = w.astype(np.float32) * sw[None, :]
        tol = K * 2.0 ** -23 * (np.abs(at.float().numpy()) @ np.abs(w_deq))
    else:
        _, e = np.frexp(np.maximum(np.abs(yj), 2.0 ** -126))
        tol = np.ldexp(1.0, e - 8)                  # one bf16 ulp of yj
    for wt in (torch.from_numpy(w), w_km):
        yt = qmatmul_w8a16_ref(at, wt, torch.from_numpy(sw), bias_t, td)
        assert yt.dtype == td
        diff = np.abs(yt.float().numpy() - yj)
        assert (diff <= tol).all(), float((diff / np.maximum(tol, 1e-30)).max())
    # the public op on the CPU is this plain version
    y_op = qmatmul_w8a16(at, w_km, torch.from_numpy(sw), bias_t)
    assert y_op.dtype == td
    assert torch.equal(y_op, yt)


def test_qmatmul_w8a16_op_on_cpu_is_the_plain_version():
    a, w, sw, bias = _w16_inputs(6, 40, 24, True, True, seed=7)
    reset_launch_counts()
    y = qmatmul_w8a16(torch.from_numpy(a), torch.from_numpy(w),
                      torch.from_numpy(sw), torch.from_numpy(bias),
                      out_dtype=torch.float32)
    assert torch.equal(y, qmatmul_w8a16_ref(
        torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(sw),
        torch.from_numpy(bias), torch.float32))
    assert launch_counts()["qmatmul_w8a16"] == 0   # no kernel on the CPU
    assert dispatch.pad_convention("qmatmul_w8a16") == "zero"
    assert dispatch.resolve("qmatmul_w8a16", y).__name__ == "_w8a16_torch"
    # the quantize-out variant on the CPU is its own plain version too
    q, s = qmatmul_w8a16(torch.from_numpy(a), torch.from_numpy(w),
                         torch.from_numpy(sw), quantize_out=True)
    qr, sr = qmatmul_w8a16_q8_ref(torch.from_numpy(a), torch.from_numpy(w),
                                  torch.from_numpy(sw))
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert launch_counts()["qmatmul_w8a16_q8"] == 0


def test_w8a16_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import _build

    with pytest.raises(ValueError, match="CUDA"):
        qmatmul_w8a16_cuda(torch.zeros(4, 8), torch.zeros(8, 4,
                                                          dtype=torch.int8),
                           torch.ones(1))
    assert _build._LIB.handle is None


# ----------------------------------------------- quantize_kv / append

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_bit_equal(seed):
    rng = np.random.RandomState(seed)
    t = (rng.randn(3, 5, 2, 16) * rng.choice([1e-4, 1.0, 10.0])).astype(np.float32)
    t[0, 0, 0] = 0.0
    qj, sj = jax_quantize_kv(jnp.asarray(t))
    qt, st = quantize_kv(torch.from_numpy(t))
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("per_slot", [True, False])
def test_append_quantize_bit_equal_and_in_place(per_slot):
    rng = np.random.RandomState(7)
    B, S, T, H, hd = 3, 12, 4, 2, 16
    ck = rng.randint(-127, 128, (B, S, H, hd)).astype(np.int8)
    cv = rng.randint(-127, 128, (B, S, H, hd)).astype(np.int8)
    cks = rng.rand(B, S, H).astype(np.float32)
    cvs = rng.rand(B, S, H).astype(np.float32)
    kn = rng.randn(B, T, H, hd).astype(np.float32)
    vn = rng.randn(B, T, H, hd).astype(np.float32)
    idx = ((rng.randint(0, S, (B, 1)) + np.arange(T)[None]) % S if per_slot
           else (np.arange(T) + 9) % S).astype(np.int32)
    jl = jax_append(jnp.asarray(ck), jnp.asarray(cks), jnp.asarray(cv),
                    jnp.asarray(cvs), jnp.asarray(kn), jnp.asarray(vn),
                    jnp.asarray(idx))
    tl = [torch.from_numpy(a.copy()) for a in (ck, cks, cv, cvs)]
    out = append_quantize(*tl, torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.from_numpy(idx).long())
    for a, b, o in zip(jl, tl, out):
        assert o is b                                  # updated in place
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pad_to_block_zero_scale():
    kq = torch.ones((1, 5, 1, 4), dtype=torch.int8)
    ks = torch.ones((1, 5, 1))
    kq_p, ks_p, _, _, blk = pad_to_block(kq, ks, kq, ks, blk=4)
    assert blk == 4 and kq_p.shape[1] == 8 and float(ks_p[0, 5:].abs().sum()) == 0
    assert pad_to_block(kq, ks, kq, ks, blk=16)[4] == 5      # S < blk


# ------------------------------------------------------------ fused decode

FD_CASES = [  # (B, Hq, Hkv, hd, S, blk)
    (2, 4, 4, 16, 33, 32),        # GQA group 1, S = 33 over blk = 32
    (3, 4, 2, 16, 20, 32),        # group 2, S < blk
    (2, 7, 1, 8, 64, 16),         # group 7, four blocks
]


def _fd_inputs(B, Hq, Hkv, hd, S, seed):
    rng = np.random.RandomState(seed)
    ck = rng.randint(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    cv = rng.randint(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    cks = (rng.rand(B, S, Hkv) * 0.02).astype(np.float32)
    cvs = (rng.rand(B, S, Hkv) * 0.02).astype(np.float32)
    q = rng.randn(B, Hq, hd).astype(np.float32)
    kn = (rng.randn(B, 1, Hkv, hd) * 2).astype(np.float32)
    vn = rng.randn(B, 1, Hkv, hd).astype(np.float32)
    lens = rng.randint(1, S + 1, B)
    lens[0] = S                                        # write at the ring end
    idx = (lens - 1)[:, None].astype(np.int32)
    valid = np.arange(S)[None] < lens[:, None]
    valid[-1] = False                                  # a fully masked row
    return ck, cks, cv, cvs, q, kn, vn, idx, valid


@pytest.mark.parametrize("quantize_out", [True, False])
@pytest.mark.parametrize("case", FD_CASES, ids=lambda c: f"g{c[1] // c[2]}-S{c[4]}-blk{c[5]}")
def test_fused_decode_ref_vs_jax_ref(case, quantize_out):
    B, Hq, Hkv, hd, S, blk = case
    ck, cks, cv, cvs, q, kn, vn, idx, valid = _fd_inputs(B, Hq, Hkv, hd, S,
                                                          seed=S + Hq)
    res_j, leaves_j = jax_fused_decode(
        *(jnp.asarray(a) for a in (q, ck, cks, cv, cvs, kn, vn, idx)),
        valid=jnp.asarray(valid), out_dtype=jnp.float32, backend="ref",
        blk=blk, quantize_out=quantize_out)
    leaves_t = [torch.from_numpy(a.copy()) for a in (ck, cks, cv, cvs)]
    res_t, out_leaves = fused_decode_ref(
        torch.from_numpy(q), *leaves_t, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(idx).long(),
        valid=torch.from_numpy(valid), out_dtype=torch.float32, blk=blk,
        quantize_out=quantize_out)
    for a, b in zip(leaves_j, out_leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    out_j = np.asarray(res_j[0] if quantize_out else res_j)
    out_t = (res_t[0] if quantize_out else res_t).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)
    assert np.all(out_t[-1] == 0.0)                     # fully masked → 0
    if quantize_out:
        qj, sj = np.asarray(res_j[1]), np.asarray(res_j[2])
        qt, st = res_t[1].numpy(), res_t[2].numpy()
        np.testing.assert_allclose(st, sj, rtol=1e-5)
        diff = np.abs(qt.astype(np.int32) - qj.astype(np.int32))
        assert diff.max() <= 1
        frac = np.abs(np.abs(out_j.reshape(B, -1) / sj[:, None]) % 1.0 - 0.5)
        assert np.all(frac[diff > 0] < 1e-3), "int8 mismatch away from a tie"
        print(f"quantize-out int8 off by one at {int((diff > 0).sum())} "
              f"of {diff.size} (ties)")


def test_kv_attention_ref_blocks_agree():
    """The blocked oracle does not depend on its block (up to float32
    summation order)."""
    ck, cks, cv, cvs, q, *_, valid = _fd_inputs(2, 4, 2, 16, 40, seed=11)
    args = [torch.from_numpy(a) for a in (q, ck, cks, cv, cvs)]
    a = kv_attention_ref(*args, blk=512)
    b = kv_attention_ref(*args, blk=8)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_fused_decode_op_in_place_and_uncounted_on_cpu():
    ck, cks, cv, cvs, q, kn, vn, idx, valid = _fd_inputs(2, 4, 2, 16, 16, 5)
    leaves = [torch.from_numpy(a.copy()) for a in (ck, cks, cv, cvs)]
    reset_launch_counts()
    (out, oq, os_), updated = fused_decode(
        torch.from_numpy(q), *leaves, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(idx).long(),
        valid=torch.from_numpy(valid), quantize_out=True)
    assert all(u is l for u, l in zip(updated, leaves))
    assert oq.shape == (2, 4 * 16) and oq.dtype == torch.int8
    ref, _ = fused_decode_ref(
        torch.from_numpy(q), *[torch.from_numpy(a.copy()) for a in (ck, cks, cv, cvs)],
        torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(idx).long(), valid=torch.from_numpy(valid),
        quantize_out=True)
    assert torch.equal(out, ref[0]) and torch.equal(oq, ref[1])
    assert launch_counts()["fused_decode"] == 0


# ------------------------------------------------------------ quantize_param

@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_param_bit_equal(per_channel):
    w = np.random.RandomState(3).randn(2, 24, 40).astype(np.float32)
    qj = jax_quantize_param(jnp.asarray(w), per_channel=per_channel, mode="w8a8")
    qt = quantize_param(torch.from_numpy(w), per_channel=per_channel, mode="w8a8")
    np.testing.assert_array_equal(np.asarray(qj.q), qt.q.numpy())
    np.testing.assert_array_equal(np.asarray(qj.scale), qt.scale.numpy())
    assert qt.q.shape == (2, 24, 40) and qt.q.transpose(-1, -2).is_contiguous()


# ------------------------------------------------------------ dispatch

def test_registry_resolves_by_device():
    x = torch.zeros(2, 3)
    assert dispatch.tier_for(x) == "torch"
    assert dispatch.resolve("quantize_act", x).__name__ == "_qact_torch"
    assert set(dispatch.ops()) >= {"quantize_act", "qmatmul_w8a8", "fused_decode"}
    assert dispatch.pad_convention("fused_decode") == "zero-scale"
    assert dispatch.pad_convention("qmatmul_w8a8") == "zero"
    with pytest.raises(KeyError, match="unknown kernel op"):
        dispatch.resolve("nope", x)


def test_registry_refuses_conflicts():
    with pytest.raises(ValueError, match="unknown tier"):
        dispatch.register_impl("x", "pallas")
    try:
        dispatch.register_impl("_probe", "torch", pad="zero")(lambda: None)
        with pytest.raises(ValueError, match="disagree on the pad"):
            dispatch.register_impl("_probe", "cuda", pad="zero-scale")(
                lambda: None)
    finally:
        for table in (dispatch._REGISTRY, dispatch._PAD, dispatch._LAUNCHES):
            table.pop("_probe", None)
    with pytest.raises(ValueError, match="already has"):
        dispatch.register_impl("quantize_act", "cuda")(lambda *a, **k: None)


def test_launch_counters():
    reset_launch_counts()
    dispatch.count_launch("quantize_act")
    dispatch.count_launch("quantize_act")
    assert launch_counts()["quantize_act"] == 2
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on the card or raises — it never takes the
    plain version itself, and never reaches the CUDA build on the CPU."""
    from repro_torch.kernels import _build

    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_act_cuda(x)
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="cpu"):
        qmatmul_w8a8_cuda(a, a.t(), torch.ones(4), torch.ones(4),
                          torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        fused_decode_cuda(torch.zeros(1, 2, 4), *([None] * 8))
    assert _build._LIB.handle is None
