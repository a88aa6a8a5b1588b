"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside its body whether the host has a
card and skips with a reason when it has none (a CUDA kernel has no
interpret mode). On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py:

  * quantize_act and qmatmul_w8a8 bit-equal;
  * qmatmul_w8a16 within E = ``16 · sqrt(K) · 2⁻²⁴ · sqrt(a² @ w_deq²)
    + 2⁻²² · (|y| + |bias|)`` in float32 — the random-walk size of the
    rounding of two float32 sums of the same products, which a TF32
    product exceeds (checked) — and E plus one bf16 ulp in bfloat16 (the
    kernel applies the scale after the sum, the plain version before it;
    one ulp alone fails where the sum cancels);
  * ``repro_torch.quantize`` on the card bit-equal to the same call on the
    CPU, but ``bo`` (a matrix product's rounding bound);
  * fused_decode's appended cache bit-equal, its float32 output within
    T = atol 1e-6 + rtol 1e-5 and its bfloat16 output within T plus one
    bf16 ulp (one ulp alone fails near zero), its quantize-out bit-equal to
    quantize_act of the kernel's own output and off the plain version's by
    one only at a rounding tie (or, in bfloat16, where that output element
    moved).
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
    tol = 1e-6 + 1e-5 * r.abs()
    if dtype == torch.bfloat16:
        _, e = torch.frexp((r.abs() + tol).clamp_min(2.0 ** -126))
        tol = tol + torch.ldexp(torch.ones_like(r), e - 8)
    assert bool((diff <= tol).all())
    assert float(out[2].abs().max()) == 0.0
    qs, ss = quantize_act_ref(o)                 # the epilogue's own formula
    assert torch.equal(oq, qs) and torch.equal(os_, ss)
    dq = (oq.int() - oqr.int()).abs()
    tie = ((r / osr[:, None]).abs() % 1.0 - 0.5).abs() < 1e-3
    allowed = tie | (diff > 0) if dtype == torch.bfloat16 else tie
    assert int(dq.max()) <= 1 and not bool(((dq > 0) & ~allowed).any())


def _w8a16_tolerance(a, w_q, w_scale, bias, y_ref):
    """E = 16 · sqrt(K) · 2⁻²⁴ · sqrt(a² @ w_deq²) + 2⁻²² · (|y| + |bias|)
    (float32: two sums of the same K products rounded in other orders),
    plus one bf16 ulp of |y_ref| + E (bfloat16: each rounded once more)."""
    w_deq = w_q.float() * torch.atleast_1d(w_scale).float()[None, :]
    norm = torch.sqrt(a.float().square() @ w_deq.square())
    e = 16 * a.shape[1] ** 0.5 * 2.0 ** -24 * norm + 2.0 ** -22 * (
        y_ref.float().abs() + (0 if bias is None else bias.float().abs()))
    if y_ref.dtype != torch.bfloat16:
        return e
    _, ex = torch.frexp((y_ref.float().abs() + e).clamp_min(2.0 ** -126))
    return e + torch.ldexp(torch.ones_like(e), ex - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmatmul_w8a16_kernel_against_plain_ragged(dev, dtype):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a16 import (
        qmatmul_w8a16,
        qmatmul_w8a16_ref,
    )

    for M, K, N, per_channel, with_bias in (
            (1, 16, 8, True, True), (5, 33, 17, False, True),
            (40, 96, 72, True, False), (8, 896, 128, False, True),
            (70, 200, 130, True, True)):
        a = torch.randn((M, K), device=dev).to(dtype)
        w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8).t()
        sw = torch.rand(N if per_channel else 1, device=dev) * 0.01 + 1e-4
        bias = torch.randn(N, device=dev) if with_bias else None
        reset_launch_counts()
        y = qmatmul_w8a16(a, w, sw, bias)
        assert launch_counts()["qmatmul_w8a16"] == 1
        yr = qmatmul_w8a16_ref(a, w, sw, bias, dtype)
        assert y.dtype == dtype
        diff = (y.float() - yr.float()).abs()
        tol = _w8a16_tolerance(a, w, sw, bias, yr)
        assert bool((diff <= tol).all()), (M, K, N, float(diff.max()))
    with pytest.raises(ValueError, match="out_dtype"):
        qmatmul_w8a16(a, w, sw, bias, out_dtype=torch.float16)


def test_w8a16_tolerance_rejects_a_tf32_product(dev):
    """The float32 tolerance is tight enough to catch TF32: the plain
    version with TF32 allowed falls outside it at a path shape."""
    from repro_torch.kernels.qmatmul_w8a16 import qmatmul_w8a16_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((8, 896), generator=gen, device=dev)
    w = torch.randint(-127, 128, (896, 896), generator=gen, device=dev,
                      dtype=torch.int8).t()
    sw = torch.full((1,), 0.005, device=dev)
    yr = qmatmul_w8a16_ref(a, w, sw, None, torch.float32)
    tol = _w8a16_tolerance(a, w, sw, None, yr)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_tf32 = qmatmul_w8a16_ref(a, w, sw, None, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert bool(((y_tf32 - yr).abs() > tol).any())


def test_serving_on_the_card_launches_every_kernel(dev):
    """serve-w8a8-kv8 runs quantize_act, qmatmul_w8a8 and fused_decode."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    run = repro_torch.serve(repro_torch.ServeConfig(
        smoke=True, quantize="w8a8", trace=4, slots=2, prompt_len=12,
        gen_len=6, prefill_chunk=4))
    assert all(r.status == "ok" for r in run.results.values())
    counts = launch_counts()
    assert min(counts[k] for k in ("quantize_act", "qmatmul_w8a8",
                                   "fused_decode")) > 0
    assert counts["qmatmul_w8a16"] == 0


def test_w8a16_serving_launches_its_kernels_only(dev):
    """serve-w8a16-kv8, the default, runs qmatmul_w8a16 and fused_decode,
    and no quantize_act or qmatmul_w8a8."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    run = repro_torch.serve(repro_torch.ServeConfig(
        smoke=True, trace=4, slots=2, prompt_len=12, gen_len=6,
        prefill_chunk=4))
    assert all(r.status == "ok" for r in run.results.values())
    counts = launch_counts()
    assert counts["qmatmul_w8a16"] > 0 and counts["fused_decode"] > 0
    assert counts["quantize_act"] == 0 and counts["qmatmul_w8a8"] == 0


def _hostile_smoke(model):
    """Seeded smoke weights that need every rewrite: log-normal norm gains,
    random attention biases, MLP hidden channels spread by a
    function-preserving rescale."""
    gen = torch.Generator().manual_seed(2)
    params = model.init(0, device="cpu")
    blocks, mlp = params["blocks"], params["blocks"]["mlp"]
    for norm in ("attn_norm", "mlp_norm"):
        blocks[norm]["w"] = torch.exp(
            torch.randn(blocks[norm]["w"].shape, generator=gen) * 0.5)
    for k in ("bq", "bk", "bv", "bo"):
        blocks["attn"][k] = torch.randn(blocks["attn"][k].shape,
                                        generator=gen) * 0.5
    s = torch.exp(torch.randn((mlp["wu"].shape[0], mlp["wu"].shape[-1]),
                              generator=gen) * 2.3)
    mlp["wu"] = mlp["wu"] * s[:, None, :]
    mlp["wd"] = mlp["wd"] / s[:, :, None]
    return params


@pytest.mark.parametrize("recipe", ["serve-w8a16-kv8", "serve-w8a8-kv8"])
def test_quantize_on_the_card_matches_the_cpu(dev, recipe):
    """DFQ on the card: every payload, scale and float leaf bit-equal to the
    CPU pipeline's, but ``bo`` (its value-bias shift is a matrix product:
    n · 2⁻²³ · (|c| @ |wo|) plus one ulp); per-site SQNR within 1e-4 dB."""
    import repro_torch
    from repro_torch.quantized import QTensor

    model = repro_torch.build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    params = _hostile_smoke(model)
    cpu = repro_torch.quantize(model, params, recipe=recipe, device="cpu")
    card = repro_torch.quantize(model, params, recipe=recipe, device=dev)
    attn = repro_torch.quantize(model, params, recipe=["fold_norm", "cle"],
                                device="cpu").params["blocks"]["attn"]
    cfg = model.cfg
    L, group = attn["bv"].shape[0], cfg.n_heads // cfg.n_kv_heads
    c = attn["bv"].reshape(L, cfg.n_kv_heads, 1, cfg.head_dim).expand(
        L, cfg.n_kv_heads, group, cfg.head_dim).reshape(L, -1)
    bo_tol = c.shape[-1] * 2.0 ** -23 * torch.einsum(
        "ln,lno->lo", c.abs(), attn["wo"].abs())

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, QTensor):
            yield path + ("q",), tree.q
            yield path + ("scale",), tree.scale
        else:
            yield path, tree

    want, got = dict(leaves(cpu.params)), dict(leaves(card.params))
    assert sorted(want) == sorted(got)
    for path, t in want.items():
        g = got[path].cpu()
        if path == ("blocks", "attn", "bo"):
            ulp = torch.nextafter(t.abs(), torch.tensor(float("inf"))) - t.abs()
            assert bool(((g - t).abs() <= bo_tol + ulp).all())
        else:
            assert torch.equal(g, t), path
    pack = [next(r for r in q.report if r["stage"] == "pack")["metrics"]
            for q in (cpu, card)]
    for site, db in pack[0]["sqnr_db"].items():
        assert abs(db - pack[1]["sqnr_db"][site]) <= 1e-4, site
