"""The quantize-in W8A8 op (``qmatmul_w8a8_qin``) and the routing that
folds ``quantize_act`` into the W8A8 GEMM, on the CPU.

The same numpy inputs, made from a seed, go through the JAX composition
``quantize_act`` (ref tier) → ``qmatmul_w8a8`` (ref tier) — what the JAX
package's ``quantize_input`` / ``qtensor_matmul`` run — and the port's op.
Tolerance: bit-equal, payload, scale and output alike (the max is
order-independent, division and round-half-even are IEEE, the integer sum
is exact and the float32 epilogue is the same three operations in the same
order). On the CPU the op is the plain composition and launches nothing;
``qtensor_matmul`` and the model's shared W8A8 projections give the same
bits whether the plan folds or not. The kernel itself runs on the card
only (``test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_ref as jax_qmm_ref
from repro.kernels.quantize_act.ref import quantize_act_ref as jax_qact_ref

from repro_torch.kernels import dispatch, gemm_plan, launch_counts, reset_launch_counts
from repro_torch.kernels.qmatmul_w8a8 import (
    qmatmul_w8a8,
    qmatmul_w8a8_qin,
    qmatmul_w8a8_qin_ref,
)
from repro_torch.kernels.qmatmul_w8a8.kernel import qmatmul_w8a8_qin_cuda
from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref
from repro_torch.models import layers
from repro_torch.quantized import qtensor
from repro_torch.quantized.qtensor import QTensor, quantize_param

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (M, K, N): decode rows at the path's q/o and down widths, a prefill
# chunk's rows, one row, and ragged K (not a multiple of 16 or of 64)
CASES = [(8, 896, 64), (8, 4864 // 8, 40), (256, 96, 24), (1, 40, 8),
         (5, 33, 17), (3, 100, 130)]


def _inputs(M, K, N, seed):
    """x with .5 ties (row 0: its only large value 127 in its last element,
    so its scale is exactly 1) and an all-zero row; a K-major int8 weight,
    per-channel scales, a bias."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * 3).astype(np.float32)
    x[0, :5] = [0.5, 1.5, -2.5, 2.5, -0.5][: min(5, K)]
    x[0, K - 1] = 127.0
    if M > 1:
        x[1] = 0.0
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    sw = (rng.rand(N) * 0.01 + 1e-4).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    return x, w, sw, bias


def _k_major(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.T)).t()


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_qin_op_bit_equal_to_jax_composition(case, xdt, out):
    M, K, N = case
    x, w, sw, bias = _inputs(M, K, N, seed=M + K + N)
    jx, tx = DTYPES[xdt]
    jo, to = DTYPES[out]
    qj, sj = jax_qact_ref(jnp.asarray(x).astype(jx))
    yj = np.asarray(jax_qmm_ref(qj, jnp.asarray(w), sj, jnp.asarray(sw),
                                jnp.asarray(bias), jo).astype(jnp.float32))
    xt = torch.from_numpy(x).to(tx)
    qt, st = quantize_act_ref(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[0]) == 1.0                           # the ties' scale
    if M > 1:
        assert float(st[1]) == np.float32(1e-8) / np.float32(127.0)
    yt = qmatmul_w8a8_qin(xt, _k_major(w), torch.from_numpy(sw),
                          torch.from_numpy(bias), out_dtype=to)
    assert yt.dtype == to
    np.testing.assert_array_equal(yt.float().numpy(), yj)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_qin_op_on_cpu_is_the_plain_composition(xdt):
    x, w, sw, bias = _inputs(6, 72, 20, seed=3)
    xt = torch.from_numpy(x).to(xdt)
    assert dispatch.resolve("qmatmul_w8a8_qin", xt).__name__ == "_w8a8_qin_torch"
    assert dispatch.pad_convention("qmatmul_w8a8_qin") == "zero"
    reset_launch_counts()
    y = qmatmul_w8a8_qin(xt, _k_major(w), torch.from_numpy(sw),
                         torch.from_numpy(bias), out_dtype=xdt)
    a_q, a_s = quantize_act(xt)
    y_pair = qmatmul_w8a8(a_q, _k_major(w), a_s, torch.from_numpy(sw),
                          torch.from_numpy(bias), out_dtype=xdt)
    assert torch.equal(y, y_pair)
    assert torch.equal(y, qmatmul_w8a8_qin_ref(xt, _k_major(w),
                                               torch.from_numpy(sw),
                                               torch.from_numpy(bias), xdt))
    assert set(launch_counts().values()) == {0}          # no kernel on the CPU


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_qin_op_hands_out_the_quantized_activation(xdt):
    """``quantized=True``: (y, x_q, x_scale), x_q and x_scale bit-equal to
    quantize_act(x) (and to the JAX quantize_act), y unchanged."""
    x, w, sw, bias = _inputs(8, 96, 24, seed=11)
    xt = torch.from_numpy(x).to(xdt)
    args = (xt, _k_major(w), torch.from_numpy(sw), torch.from_numpy(bias))
    y, a_q, a_s = qmatmul_w8a8_qin(*args, quantized=True)
    q_ref, s_ref = quantize_act(xt)
    assert torch.equal(y, qmatmul_w8a8_qin(*args))
    assert torch.equal(a_q, q_ref) and torch.equal(a_s, s_ref)
    qj, sj = jax_qact_ref(jnp.asarray(x).astype(DTYPES[str(xdt)[6:]][0]))
    np.testing.assert_array_equal(a_q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(a_s.numpy(), np.asarray(sj))


def test_qin_op_without_bias_and_with_a_tensor_scale():
    """bias None and a per-tensor [1] weight scale, as ``qmatmul_w8a8``
    takes them: the same bits as that op on quantize_act's output."""
    x, w, _, _ = _inputs(4, 48, 16, seed=5)
    xt, wt, sw = torch.from_numpy(x), _k_major(w), torch.tensor([0.003])
    a_q, a_s = quantize_act(xt)
    assert torch.equal(qmatmul_w8a8_qin(xt, wt, sw),
                       qmatmul_w8a8(a_q, wt, a_s, sw))


def test_qin_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on the card or raises; on the CPU it
    never reaches the CUDA build."""
    from repro_torch.kernels import _build

    x = torch.zeros(4, 32)
    w = torch.zeros(32, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="cpu"):
        qmatmul_w8a8_qin_cuda(x, w.t().contiguous().t(), torch.ones(8),
                              torch.zeros(8))
    assert _build._LIB.handle is None


def _w8a8(K, N, seed):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.randn(K, N) * 0.05).astype(np.float32))
    return quantize_param(w, mode="w8a8")


def _record(monkeypatch):
    """Count the calls of the quantize-in op and of the shared quantize
    (``quantize_input``'s ``quantize_act``) the routing makes."""
    from repro_torch.kernels.qmatmul_w8a8 import ops as qmm_ops
    from repro_torch.kernels.quantize_act import ops as qact_ops

    calls = {"qin": 0, "quantize_act": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    qin = counted("qin", qmm_ops.qmatmul_w8a8_qin)
    monkeypatch.setattr(qmm_ops, "qmatmul_w8a8_qin", qin)
    monkeypatch.setattr(layers, "qmatmul_w8a8_qin", qin)
    monkeypatch.setattr(qact_ops, "quantize_act",
                        counted("quantize_act", qact_ops.quantize_act))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(8, 1), (2, 1), (8, 32)])
def test_qtensor_matmul_same_bits_as_before(B, T, dtype, monkeypatch):
    """A W8A8 ``qtensor_matmul`` gives the bits of quantize_input +
    qtensor_matmul_prequant (the route before the fold); it folds where the
    plan does (decode rows) and quantizes once elsewhere (a prefill chunk
    of 8 x 32 rows)."""
    K, N = 96, 40
    w = _w8a8(K, N, seed=B + T)
    bias = torch.from_numpy(np.random.RandomState(1).randn(N).astype(np.float32))
    x = torch.from_numpy(np.random.RandomState(2).randn(B, T, K)
                         .astype(np.float32) * 2).to(dtype)
    a_q, a_s, lead = qtensor.quantize_input(x)
    before = qtensor.qtensor_matmul_prequant(a_q, a_s, w, bias, lead,
                                             out_dtype=dtype)
    calls = _record(monkeypatch)
    y = qtensor.qtensor_matmul(x, w, bias)
    assert y.shape == (B, T, N) and y.dtype == dtype
    assert torch.equal(y, before)
    folds = gemm_plan.plan(B * T, N, K).fold
    assert folds == (B * T <= 16)
    assert calls == {"qin": int(folds), "quantize_act": int(not folds)}


@pytest.mark.parametrize("B,T", [(8, 1), (8, 32)])
def test_shared_linears_same_bits_as_before(B, T, monkeypatch):
    """The qkv trio and the gate/up pair: each output bit-equal to its own
    ``linear`` and to the shared-quantize route; at decode the first GEMM
    quantizes x itself and hands it to the others (no quantize_act), in a
    prefill chunk the projections share one quantize_act."""
    D = 64
    x = torch.from_numpy(np.random.RandomState(7).randn(B, T, D)
                         .astype(np.float32))
    trio = [(_w8a8(D, n, seed=i), torch.full((n,), 0.1 * i))
            for i, n in enumerate((D, 16, 16))]
    pair = [(_w8a8(D, 3 * D, seed=10 + i), None) for i in range(2)]
    for wbs in (trio, pair):
        a_q, a_s, lead = qtensor.quantize_input(x)
        before = [qtensor.qtensor_matmul_prequant(a_q, a_s, w, b, lead)
                  for w, b in wbs]
        calls = _record(monkeypatch)
        got = layers._shared_linears(x, wbs)
        folds = B * T <= 16
        assert calls == {"qin": int(folds), "quantize_act": int(not folds)}
        for g, b_, (w, b) in zip(got, before, wbs):
            assert torch.equal(g, b_)
            assert torch.equal(g, layers.linear(x, w, b))


def test_quantizes_in_gemm_needs_every_projection_to_fold():
    x = torch.zeros(8, 1, 896)
    small, huge = _w8a8(896, 8, 0), QTensor(
        torch.zeros(896, 8, dtype=torch.int8), torch.ones(8), "w8a8")
    assert qtensor.quantizes_in_gemm(x, small, huge)
    assert not qtensor.quantizes_in_gemm(torch.zeros(256, 896), small)
    # a K whose int8 slice does not fit beside the ring even in 16 splits
    K = 1 << 18
    wide = torch.zeros(8, K)
    w_wide = QTensor(torch.zeros(K, 8, dtype=torch.int8), torch.ones(8),
                     "w8a8")
    assert gemm_plan.plan(8, 8, K).splits == gemm_plan.MAX_SPLITS
    assert not gemm_plan.plan(8, 8, K).qin_fits
    assert not qtensor.quantizes_in_gemm(wide, w_wide)
