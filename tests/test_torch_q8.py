"""The quantize-out GEMMs' plain versions against the JAX package on the CPU.

``qmatmul_w8a8(..., quantize_out=True)`` and ``qmatmul_w8a16(...,
quantize_out=True)`` return (int8 [M, N], float32 scale [M]), the
``quantize_act`` formula applied to the GEMM's float32 result. Inputs are
made with numpy from a seed. Tolerances:

  * W8A8: bit-equal to JAX ``qmatmul_w8a8_q8_ref`` and to the port's own
    stepwise pair (the float32 GEMM, then ``quantize_act``) — the integer
    accumulation is exact, so nothing may differ.
  * W8A16: the float32 sums of XLA and PyTorch run in other orders, so a
    payload may sit one step from JAX ``qmatmul_w8a16_q8_ref``'s where y is
    within a rounding of a .5 boundary: at most one step apart, and in at
    most 0.5 % of the values (measured: none of 8,218); the scale within
    rtol 1e-6 (measured max 4.2e-7, at K = 1100). bfloat16 ``a`` is cast to
    float32 by both (the products are exact).

The plain versions also take ``bits`` (qmax = 2^(bits-1) - 1, the clip at
[-qmax - 1, qmax]) as the Pallas functions do: at bits 4, 6 and 8 they are
held against ``qmatmul_w8a8_q8_pallas`` and ``qmatmul_w8a16_q8_pallas`` run
in interpret mode, on shapes those take (M % bm == 0, K % bk == 0), with
the W8A16 tolerance above (the W8A16 plain version blocked by the Pallas
bk). In interpret mode XLA computes the Pallas epilogue with its own CPU
arithmetic (acc·sa·sw + bias contracted, the division by the constant qmax
rewritten): its W8A8 scales lie up to 2 float32 ulp from the JAX package's
own ``qmatmul_w8a8_q8_ref`` (measured at these shapes; payloads equal), so
W8A8 is held bit-equal to that reference at every ``bits`` and to the
interpret run within the W8A16 tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.qmatmul_w8a8.kernel import qmatmul_w8a8_q8_pallas
from repro.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_q8_ref as jax_w8a8_q8
from repro.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_q8_pallas
from repro.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_q8_ref as jax_w8a16_q8

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.qmatmul_w8a8 import qmatmul_w8a8, qmatmul_w8a8_q8_ref
from repro_torch.kernels.qmatmul_w8a16 import (
    qmatmul_w8a16,
    qmatmul_w8a16_q8_ref,
)
from repro_torch.kernels.quantize_act import quantize_act

# (M, K, N): decode and prefill rows, ragged K and N, K over one 1024 block
SHAPES = [(8, 64, 128), (5, 33, 17), (40, 96, 72), (3, 1100, 40)]


def _w8a8_inputs(M, K, N, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-128, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    sa = (rng.rand(M) * 0.05 + 1e-4).astype(np.float32)
    sw = (rng.rand(N) * 0.01 + 1e-4).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    return a, w, sa, sw, bias


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_q8_bit_equal_to_jax_and_the_pair(shape):
    arrays = _w8a8_inputs(*shape, seed=sum(shape))
    jq, js = jax_w8a8_q8(*map(jnp.asarray, arrays))
    t = [torch.from_numpy(x) for x in arrays]
    reset_launch_counts()
    q, s = qmatmul_w8a8(*t, quantize_out=True)
    assert set(launch_counts().values()) == {0}          # the CPU: no kernel
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    qp, sp = quantize_act(qmatmul_w8a8(*t))
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(q, qmatmul_w8a8_q8_ref(*t)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a16_q8_matches_jax(shape, dtype):
    M, K, N = shape
    rng = np.random.RandomState(sum(shape) + 1)
    a = rng.randn(M, K).astype(np.float32)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    sw = (rng.rand(N) * 0.01 + 1e-4).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    ja = jnp.asarray(a).astype(dtype)
    jq, js = jax_w8a16_q8(ja, jnp.asarray(w), jnp.asarray(sw),
                          jnp.asarray(bias))
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    q, s = qmatmul_w8a16(ta, torch.from_numpy(w), torch.from_numpy(sw),
                         torch.from_numpy(bias), quantize_out=True)
    steps = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert steps.max() <= 1 and (steps > 0).mean() <= 0.005, (
        int((steps > 0).sum()))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    qr, sr = qmatmul_w8a16_q8_ref(ta, torch.from_numpy(w),
                                  torch.from_numpy(sw), torch.from_numpy(bias))
    assert torch.equal(q, qr) and torch.equal(s, sr)


def test_w8a16_q8_blocks_k_and_takes_a_per_tensor_scale():
    """K past one 1024 block is zero-padded and summed block by block; a
    per-tensor [1] scale broadcasts; no bias adds nothing."""
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(4, 1500).astype(np.float32))
    w = torch.from_numpy(rng.randint(-127, 128, (1500, 24)).astype(np.int8))
    sw = torch.tensor([0.003])
    q, s = qmatmul_w8a16(a, w, sw, None, quantize_out=True)
    y = (a.double() @ w.double()) * 0.003
    want_s = (y.abs().amax(-1) / 127).float()
    np.testing.assert_allclose(s.numpy(), want_s.numpy(), rtol=1e-6)
    assert int((q.double() - torch.round(y / s.double()[:, None])).abs().max()) <= 1
    qb, sb = qmatmul_w8a16_q8_ref(a, w, sw, None, bk=256)
    assert int((q.int() - qb.int()).abs().max()) <= 1
    np.testing.assert_allclose(s.numpy(), sb.numpy(), rtol=1e-6)


# (M, K, N, bm, bk) the Pallas functions take: M % bm == 0, K % bk == 0;
# N ragged (the kernels hold the whole row in one block)
PALLAS_SHAPES = [(8, 256, 72, 8, 128), (16, 384, 130, 8, 128)]


def _q8_steps_ok(q, jq, s, js):
    steps = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert steps.max() <= 1 and (steps > 0).mean() <= 0.005, int((steps > 0).sum())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("shape", PALLAS_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_w8a8_q8_bits_against_jax_and_the_pallas_kernel(shape, bits):
    """The port's W8A8 quantize-out plain version at ``bits``: bit-equal to
    the JAX package's ``qmatmul_w8a8_q8_ref(..., bits)``, and against
    ``qmatmul_w8a8_q8_pallas(..., bits, interpret=True)`` within the W8A16
    tolerance (XLA's interpret arithmetic, module docstring); the payload
    inside [-qmax - 1, qmax]."""
    M, K, N, bm, bk = shape
    arrays = _w8a8_inputs(M, K, N, seed=sum(shape) + bits)
    jq, js = qmatmul_w8a8_q8_pallas(*map(jnp.asarray, arrays), bm=bm, bk=bk,
                                    bits=bits, interpret=True)
    rq, rs = jax_w8a8_q8(*map(jnp.asarray, arrays), bits=bits)
    q, s = qmatmul_w8a8_q8_ref(*[torch.from_numpy(x) for x in arrays], bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    _q8_steps_ok(q, jq, s, js)
    qmax = 2 ** (bits - 1) - 1
    assert int(q.min()) >= -qmax - 1 and int(q.max()) <= qmax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("shape", PALLAS_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_w8a16_q8_bits_match_the_pallas_kernel(shape, bits, dtype):
    """The port's W8A16 quantize-out plain version at ``bits`` (blocked by
    the kernel's bk) against ``qmatmul_w8a16_q8_pallas(..., bits,
    interpret=True)``, within the file's W8A16 tolerance."""
    M, K, N, bm, bk = shape
    rng = np.random.RandomState(sum(shape) + bits + 1)
    a = rng.randn(M, K).astype(np.float32)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    sw = (rng.rand(N) * 0.01 + 1e-4).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    jq, js = qmatmul_w8a16_q8_pallas(
        jnp.asarray(a).astype(dtype), jnp.asarray(w), jnp.asarray(sw),
        jnp.asarray(bias), bm=bm, bk=bk, bits=bits, interpret=True)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    q, s = qmatmul_w8a16_q8_ref(ta, torch.from_numpy(w), torch.from_numpy(sw),
                                torch.from_numpy(bias), bits, bk=bk)
    _q8_steps_ok(q, jq, s, js)
    qmax = 2 ** (bits - 1) - 1
    assert int(q.min()) >= -qmax - 1 and int(q.max()) <= qmax
