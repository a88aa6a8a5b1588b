"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside its body whether the host has a
card and skips with a reason when it has none (a CUDA kernel has no
interpret mode). On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: quantize_act and qmatmul_w8a8 bit-equal;
fused_decode's appended cache bit-equal, its float32 output within
atol 1e-6 + rtol 1e-5 and its bfloat16 output within one bf16 ulp, its
quantize-out bit-equal to quantize_act of the kernel's own output and off
the plain version's by one only at a rounding tie (or, in bfloat16, where
that output element moved).
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card only")
    return torch.device("cuda", 0)


def test_quantize_act_kernel_bit_equal(dev):
    from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref

    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((13, 77), device=dev) * 4).to(dtype)
        q, s = quantize_act(x)
        qr, sr = quantize_act_ref(x)
        assert torch.equal(q, qr) and torch.equal(s, sr)


def test_qmatmul_kernel_bit_equal_ragged(dev):
    from repro_torch.kernels.qmatmul_w8a8 import qmatmul_w8a8, qmatmul_w8a8_ref

    for M, K, N in ((1, 16, 8), (5, 33, 17), (40, 96, 72)):
        a = torch.randint(-128, 128, (M, K), device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8).t()
        sa, sw = torch.rand(M, device=dev), torch.rand(N, device=dev)
        bias = torch.randn(N, device=dev)
        y = qmatmul_w8a8(a, w, sa, sw, bias)
        assert torch.equal(y, qmatmul_w8a8_ref(a, w, sa, sw, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_kernel_against_plain(dev, dtype):
    from repro_torch.kernels.fused_decode import fused_decode, fused_decode_ref
    from repro_torch.kernels.quantize_act import quantize_act_ref

    B, Hq, Hkv, hd, S = 3, 4, 2, 16, 33
    leaves = [torch.randint(-127, 128, (B, S, Hkv, hd), device=dev,
                            dtype=torch.int8), torch.rand(B, S, Hkv, device=dev),
              torch.randint(-127, 128, (B, S, Hkv, hd), device=dev,
                            dtype=torch.int8), torch.rand(B, S, Hkv, device=dev)]
    q = torch.randn(B, Hq, hd, device=dev).to(dtype)
    kn = torch.randn(B, 1, Hkv, hd, device=dev).to(dtype)
    vn = torch.randn(B, 1, Hkv, hd, device=dev).to(dtype)
    idx = torch.tensor([[S - 1], [4], [0]], device=dev)
    valid = torch.arange(S, device=dev)[None] <= idx
    valid[2] = False
    mine = [t.clone() for t in leaves]
    ref = [t.clone() for t in leaves]
    (out, oq, os_), _ = fused_decode(q, *mine, kn, vn, idx, valid=valid,
                                     out_dtype=dtype, quantize_out=True)
    (outr, oqr, osr), _ = fused_decode_ref(q, *ref, kn, vn, idx, valid=valid,
                                           out_dtype=dtype, quantize_out=True)
    for a, b in zip(mine, ref):
        assert torch.equal(a, b)
    o, r = out.float().reshape(B, -1), outr.float().reshape(B, -1)
    diff = (o - r).abs()
    if dtype == torch.bfloat16:
        _, e = torch.frexp(r.abs().clamp_min(2.0 ** -126))
        assert bool((diff <= torch.ldexp(torch.ones_like(r), e - 8)).all())
    else:
        assert bool((diff <= 1e-6 + 1e-5 * r.abs()).all())
    assert float(out[2].abs().max()) == 0.0
    qs, ss = quantize_act_ref(o)                 # the epilogue's own formula
    assert torch.equal(oq, qs) and torch.equal(os_, ss)
    dq = (oq.int() - oqr.int()).abs()
    tie = ((r / osr[:, None]).abs() % 1.0 - 0.5).abs() < 1e-3
    allowed = tie | (diff > 0) if dtype == torch.bfloat16 else tie
    assert int(dq.max()) <= 1 and not bool(((dq > 0) & ~allowed).any())


def test_serving_on_the_card_launches_every_kernel(dev):
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    run = repro_torch.serve(repro_torch.ServeConfig(
        smoke=True, trace=4, slots=2, prompt_len=12, gen_len=6,
        prefill_chunk=4))
    assert all(r.status == "ok" for r in run.results.values())
    assert min(launch_counts().values()) > 0
