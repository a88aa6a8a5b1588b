"""The MoE family (mixtral-8x22b: 8 experts top-2 and a sliding window;
llama4-scout-17b-a16e: 16 experts top-1 and a shared expert) against the
JAX package, at smoke size on the same weights.

Tolerances: float32 forwards agree within ``FWD_TOL`` (summation order
only: measured ≤ 2.4e-7 on the MoE block's output); bfloat16 within one
bf16 ulp of the output's scale (``BF16_TOL``: the frameworks round bf16 at
other places). Cached decoding over the int8 cache within ``LOGIT_TOL``,
as the port's other cache tests. Quantized weights are bit-equal; served
tokens are equal.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro
from _torch_port import jax_to_numpy
from repro.configs import get_config as jax_get_config
from repro.core.adversarial import hostile_rescale as jax_hostile_rescale
from repro.models import build_model as jax_build_model
from repro.models.layers import _moe_block_local

import torch

import repro_torch
from repro_torch import get_config
from repro_torch.core import DFQConfig, apply_dfq, dfq_quantize, sqnr_db
from repro_torch.core.adversarial import hostile_rescale
from repro_torch.data import calibration_tokens
from repro_torch.models import build_model
from repro_torch.models.layers import moe_block, top_k
from repro_torch.models.lm import _layer
from repro_torch.quantized.qtensor import QTensor, map_leaves
from repro_torch.serving import Request, ServingEngine
from repro_torch.weights import from_jax_numpy

MIXTRAL, LLAMA4 = "mixtral-8x22b", "llama4-scout-17b-a16e"
FWD_TOL = 1e-5
BF16_TOL = 2.0 ** -7
LOGIT_TOL = 1e-3


def _pair(arch, **replace):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                                    device="cpu")


@pytest.fixture(scope="module")
def mixtral():
    return _pair(MIXTRAL)


@pytest.fixture(scope="module")
def llama4():
    return _pair(LLAMA4)


# (arch, capacity_factor or None for the smoke's, dtype, zero router)
MOE_CASES = {
    "mixtral-top2": (MIXTRAL, None, "float32", False),
    "llama4-top1-shared": (LLAMA4, None, "float32", False),
    "mixtral-drops": (MIXTRAL, 1.25, "float32", False),
    "mixtral-ties": (MIXTRAL, 1.25, "float32", True),
    "mixtral-bf16": (MIXTRAL, None, "bfloat16", False),
    "llama4-bf16-drops": (LLAMA4, 1.25, "bfloat16", False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_jax(case):
    """``moe_block`` against ``_moe_block_local`` on the carried weights of
    layer 0: the output, the aux loss and the captured stats. At
    capacity_factor 1.25 choices drop (the output differs from the
    drop-free one); a zero router gives every expert the same probability,
    and the tie goes to the lower expert index in both."""
    arch, cf, dtype, zero_router = MOE_CASES[case]
    rep = {} if cf is None else {"capacity_factor": cf}
    jm, jp, tm, tp = _pair(arch, **rep)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"])
    tl = _layer(tp["blocks"]["mlp"], 0)
    if zero_router:
        jl = {**jl, "router": jnp.zeros_like(jl["router"])}
        tl = {**tl, "router": torch.zeros_like(tl["router"])}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jl = jax.tree.map(lambda a: a.astype(jdt), jl)
    tl = map_leaves(lambda a: a.to(tdt), tl)
    x = np.random.RandomState(0).randn(3, 16, 64).astype(np.float32)
    yj, auxj, sj = _moe_block_local(jl, jnp.asarray(x).astype(jdt), jm.cfg,
                                    capture=True)
    stats = {}
    yt, auxt = moe_block(tl, torch.from_numpy(x).to(tdt), tm.cfg,
                         capture=stats)
    assert yt.dtype == tdt and sorted(stats) == sorted(sj)
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    yj = np.asarray(yj, np.float32)
    scale = np.abs(yj).max()
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0,
                               atol=tol * scale)
    assert float(auxt) == pytest.approx(float(auxj), rel=1e-6)
    for k, v in sj.items():
        v = np.asarray(v, np.float32)
        np.testing.assert_allclose(stats[k].float().numpy(), v, rtol=0,
                                   atol=tol * max(np.abs(v).max(), 1e-3),
                                   err_msg=k)
    if cf is not None and not zero_router:
        free = moe_block(tl, torch.from_numpy(x).to(tdt),
                         dataclasses.replace(tm.cfg, capacity_factor=64.0))[0]
        assert not torch.equal(free, yt), "capacity 1.25 dropped nothing"
    if zero_router:
        # every choice lands on experts 0 and 1: capacity C = 10 of 16
        # tokens, so six first choices and six second choices drop
        assert float(auxt) == pytest.approx(1.0)
        drops = []
        moe_block(tl, torch.from_numpy(x).to(tdt), tm.cfg, drops=drops)
        assert [d.tolist() for d in drops] == [[12, 12, 12]]


def test_top_k_breaks_ties_to_the_lower_index():
    p = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]])
    vals, idx = top_k(p, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3],
                                                        [0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
def test_lm_logits_and_loss_match_jax(arch, request):
    """The eval forward (causal within mixtral's 16-position window over 24
    tokens) and ``loss`` with its 0.01 x aux term."""
    jm, jp, tm, tp = request.getfixturevalue(
        "mixtral" if arch == MIXTRAL else "llama4")
    toks = np.random.RandomState(1).randint(0, 256, (2, 24))
    yj, (auxj, _) = jm.apply(jp, jnp.asarray(toks))
    yt, auxt = tm.apply(tp, torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=FWD_TOL)
    assert float(auxt) == pytest.approx(float(auxj), rel=1e-6)
    batch = {"tokens": toks[:, :16], "labels": toks[:, 1:17]}
    lj = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lt = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)


@pytest.mark.parametrize("kv_bits,per_slot", [(16, False), (8, False),
                                              (8, True)])
def test_ring_prefill_and_decode_past_the_window(mixtral, kv_bits, per_slot):
    """A 12-token prefill, then 18 decode steps over a 16-position ring
    (``cache_len``), so the ring wraps: every step's logits equal the JAX
    model's within LOGIT_TOL; over the fp cache the last step also equals
    the windowed eval forward's last position (the reference's
    ``test_sliding_window_ring_buffer``)."""
    jm, jp, tm, tp = mixtral
    B, T = 2, 30
    toks = np.random.RandomState(2).randint(0, 256, (B, T))
    jc = jm.init_cache(B, 40, dtype=jnp.float32, kv_bits=kv_bits,
                       per_slot=per_slot)
    j_prefill, j_decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    tc = tm.init_cache(B, 40, device="cpu", kv_bits=kv_bits,
                       per_slot=per_slot)
    assert tc["k"].shape[2] == jc["k"].shape[2] == 16
    jl, jc = j_prefill(jp, jnp.asarray(toks[:, :12]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :12]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    for t in range(12, T):
        jl, jc = j_decode(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {t}")
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    if kv_bits == 16:
        full = tm.apply(tp, torch.from_numpy(toks))[:, -1]
        np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=0,
                                   atol=1e-4)


PUBLIC_SIZES = {MIXTRAL: (120e9, 150e9), LLAMA4: (90e9, 120e9)}


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
def test_full_width_configs_build_as_the_reference(arch):
    """Both MoE archs at full width and smoke size: every config field the
    reference's, the parameter counts (total and active) its and inside
    ``test_models_smoke.py``'s public ranges, the model built with the
    reference's DFQ plan, the decode cell's cache a ring of the window
    (mixtral: 4096 of 32768 positions), and long_500k applicable with the
    window only."""
    from repro.models.model import cache_specs as jax_cache_specs
    from repro_torch.models import SHAPE_BY_NAME, cache_specs, shape_applicable

    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                                 smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    lo, hi = PUBLIC_SIZES[arch]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert lo <= cfg.param_count() <= hi
    model = build_model(cfg)
    assert [dataclasses.astuple(s) for s in model.dfq_plan().sites] == [
        dataclasses.astuple(s) for s in jax_build_model(jcfg).dfq_plan().sites]
    cell = SHAPE_BY_NAME["decode_32k"]
    cache = cache_specs(cfg, cell)
    want = jax_cache_specs(jcfg, cell)
    assert tuple(cache["k"].shape) == tuple(want["k"].shape)
    assert cache["k"].shape[2] == (4096 if arch == MIXTRAL else 32768)
    ok, _ = shape_applicable(cfg, SHAPE_BY_NAME["long_500k"])
    assert ok == (arch == MIXTRAL)


def _fields(op):
    return {f.name: (tuple(v) if isinstance(v, list) else v)
            for f in dataclasses.fields(op)
            for v in [getattr(op, f.name)]}


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
def test_dfq_plan_matches_jax(arch):
    """Op for op and site for site: no mlp_norm fold, the expert and shared
    up/down pairs, the router and expert sites (experts without a stat)."""
    cfg = get_config(arch, smoke=True)
    jplan = jax_build_model(jax_get_config(arch, smoke=True)).dfq_plan()
    tplan = build_model(cfg).dfq_plan()
    assert [type(op).__name__ for op in tplan.ops] == \
           [type(op).__name__ for op in jplan.ops]
    for jop, top in zip(jplan.ops, tplan.ops):
        assert _fields(top) == _fields(jop), type(top).__name__
    assert [dataclasses.astuple(s) for s in tplan.sites] == \
           [dataclasses.astuple(s) for s in jplan.sites]
    names = [s.name for s in tplan.sites]
    assert "router" in names and "experts_wd" in names


def _hostile(mixtral):
    jm, jp, tm, tp = mixtral
    return (jax_hostile_rescale(jp, jm.dfq_plan(), decades=1.2),
            hostile_rescale(tp, tm.dfq_plan(), decades=1.2))


def test_hostile_rescale_over_the_expert_pairs(mixtral):
    """The port's hostile_rescale scales every expert's up/down pair as the
    JAX one does (its normals within 4 ulp of JAX's: a few ulp on the
    weights)."""
    jh, th = _hostile(mixtral)
    for k in ("wu", "wd", "wg"):
        j = np.asarray(jh["blocks"]["mlp"]["experts"][k])
        t = th["blocks"]["mlp"]["experts"][k].numpy()
        np.testing.assert_allclose(t, j, rtol=2e-6, atol=0, err_msg=k)
    assert not np.array_equal(np.asarray(jh["blocks"]["mlp"]["experts"]["wu"]),
                              np.asarray(mixtral[1]["blocks"]["mlp"]
                                         ["experts"]["wu"]))


def test_apply_dfq_keeps_the_function_and_recovers_hostile_mixtral(mixtral):
    """``test_dfq_integration.py``'s mixtral cases on the port: apply_dfq
    keeps the fp32 logits (relative 5e-3), and on the hostile model
    dfq_quantize beats naive per-tensor int8 by 10 dB with 90 % greedy
    agreement."""
    _, _, tm, tp = mixtral
    plan = tm.dfq_plan()
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 16)))
    y0 = tm.apply(tp, toks)
    y1 = tm.apply(apply_dfq(tp, plan, DFQConfig()), toks)
    assert float((y1 - y0).abs().max()) / float(y0.abs().max()) < 5e-3
    _, hostile = _hostile(mixtral)
    y_fp = tm.apply(hostile, toks)
    from repro_torch.core import quantize_weights
    naive = quantize_weights(hostile, plan,
                             DFQConfig(cle=False, bias_absorb=False))
    q = dfq_quantize(hostile, plan, DFQConfig(),
                     input_means_fn=lambda p: tm.calibration_stats(
                         p, calibration_tokens(1, 2, 32, 256, device="cpu")))
    snr_naive = float(sqnr_db(y_fp, tm.apply(naive, toks)))
    y_dfq = tm.apply(q, toks)
    snr_dfq = float(sqnr_db(y_fp, y_dfq))
    assert snr_dfq > snr_naive + 10.0, (snr_naive, snr_dfq)
    assert float((y_fp.argmax(-1) == y_dfq.argmax(-1)).float().mean()) > 0.9


def _leaves(tree, path=()):
    if isinstance(tree, dict) and set(tree) != {"q", "scale", "mode"}:
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


PER_CHANNEL = ["fold_norm", "cle", "bias_absorb",
               ("pack", {"mode": "w8a8", "per_channel": True})]


@pytest.mark.parametrize("recipe", ["serve-w8a16", "serve-w8a8-kv8",
                                    "per-channel"])
def test_pack_bit_equal_to_jax(llama4, recipe):
    """The serve recipes on llama4 (experts [L, E, D, F], the router, the
    shared expert left in float), and a per-channel W8A8 pack: every leaf
    of ``repro_torch.quantize`` bit-equal to ``repro.quantize``'s, the
    expert payloads and their per-expert scales ([L, E, 1] per tensor,
    [L, E, N] per channel) included."""
    jm, jp, tm, tp = llama4
    recipe = PER_CHANNEL if recipe == "per-channel" else recipe
    jq = repro.quantize(jm, params=jp, recipe=recipe)
    tq = repro_torch.quantize(tm, tp, recipe=recipe, device="cpu")
    jl, tl = dict(_leaves(jax_to_numpy(jq.params))), dict(_leaves(tq.params))
    assert sorted(jl) == sorted(tl)
    for path, t in tl.items():
        if isinstance(t, QTensor):
            j = jl[path]
            assert t.mode == j["mode"], path
            np.testing.assert_array_equal(t.q.numpy(), j["q"], str(path))
            np.testing.assert_array_equal(t.scale.numpy(), j["scale"],
                                          str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), jl[path], str(path))
    experts = tl[("blocks", "mlp", "experts", "wd")]
    assert tuple(experts.q.shape) == (2, 4, 128, 64)
    assert tuple(experts.scale.shape) == (
        (2, 4, 64) if recipe is PER_CHANNEL else (2, 4, 1))
    assert not isinstance(tl[("blocks", "mlp", "shared", "wd")], QTensor)
    assert tq.cfg.kv_cache_bits == jq.cfg.kv_cache_bits


def test_expert_batched_ops_equal_the_per_expert_calls():
    """On the CPU the expert-batched GEMM ops are their plain versions,
    expert by expert: W8A16 (per-tensor and per-channel scales, a bias),
    W8A8 and the quantize-in W8A8 (its int8 rows the flat quantize_act's),
    the N = 8 router shape included."""
    from repro_torch.kernels.qmatmul_w8a8 import qmatmul_w8a8, qmatmul_w8a8_qin
    from repro_torch.kernels.qmatmul_w8a16 import qmatmul_w8a16
    from repro_torch.kernels.quantize_act import quantize_act

    g = torch.Generator().manual_seed(0)
    E, M, K = 4, 6, 64
    for N in (8, 40):
        x = torch.randn((E, M, K), generator=g)
        w = torch.randint(-127, 128, (E, K, N), dtype=torch.int8, generator=g)
        for sw in (torch.rand((E, 1), generator=g),
                   torch.rand((E, N), generator=g)):
            b = torch.randn((E, N), generator=g)
            y = qmatmul_w8a16(x, w, sw, b)
            for e in range(E):
                assert torch.equal(y[e], qmatmul_w8a16(x[e], w[e], sw[e], b[e]))
            y, aq, a_s = qmatmul_w8a8_qin(x, w, sw, b, quantized=True)
            q, s = quantize_act(x.reshape(-1, K))
            assert torch.equal(aq.reshape(-1, K), q)
            assert torch.equal(a_s.reshape(-1), s)
            y2 = qmatmul_w8a8(aq, w, a_s, sw, b)
            assert torch.equal(y, y2)
            for e in range(E):
                assert torch.equal(y2[e], qmatmul_w8a8(aq[e], w[e], a_s[e],
                                                       sw[e], b[e]))
    with pytest.raises(ValueError, match="expert axis"):
        qmatmul_w8a16(x, w, sw, quantize_out=True)


def test_engine_caps_capacity_at_the_window_ring(mixtral):
    """``test_serving_engine.py::test_engine_caps_capacity_at_sliding_window_
    ring`` on the port, contiguous and paged: the pool's ring is the
    16-position window, and a request that would wrap onto live keys is
    refused."""
    _, _, tm, tp = mixtral
    for page in (None, 8):
        eng = ServingEngine(tm, tp, tm.cfg, num_slots=2, max_len=64,
                            prefill_chunk=8, page_size=page, device="cpu")
        assert eng.max_len == 16 == eng.pool.max_len
        with pytest.raises(ValueError, match="cache positions"):
            eng.submit(Request(rid=0, prompt=[1] * 10, max_new_tokens=10))


SERVE = dict(slots=2, trace=6, prompt_len=8, gen_len=6, prefill_chunk=4)


@pytest.mark.parametrize("recipe", ["serve-w8a16", "serve-w8a16-kv8",
                                    "serve-w8a8-kv8"])
def test_serve_gives_the_jax_launchers_tokens(mixtral, tmp_path, recipe):
    """A JAX artifact of smoke mixtral under each deployment (the fp-cache
    default, and both int8-cache recipes), served by both launchers with
    ``--load``: ``repro_torch.serve`` on the contiguous and the paged pool
    gives every request the JAX launcher's tokens (the 16-position ring
    caps the trace at 13 positions a request)."""
    jm, jp, _, _ = mixtral
    d = str(tmp_path / recipe)
    repro.quantize(jm, params=jp, recipe=recipe).save(d)
    want = repro.serve(repro.ServeConfig(load=d, **SERVE))
    assert len(want) == 6
    for page in (None, 4):
        run = repro_torch.serve(repro_torch.ServeConfig(
            load=d, device="cpu", page_size=page, **SERVE))
        assert sorted(run.results) == sorted(want)
        for rid, r in want.items():
            assert run.results[rid].tokens == [int(t) for t in r.tokens], (
                page, rid)


@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_serve_refuses_what_the_reference_refuses(family):
    """``_check_servable``: the reference launcher's refusal and message;
    the engine refuses the same families."""
    from repro_torch.launch.serve import _check_servable

    cfg = dataclasses.replace(get_config(MIXTRAL, smoke=True), family=family)
    with pytest.raises(repro_torch.ServeConfigError,
                       match="attention-family decoder-only models"):
        _check_servable(cfg, "--arch x")
    with pytest.raises(ValueError, match="attention-family"):
        ServingEngine(None, None, cfg, device="cpu")


def test_serve_arch_llama4_smoke_on_its_own_weights(capsys):
    """``--arch llama4-scout-17b-a16e --smoke`` draws, quantizes (W8A8 over
    the int8 cache) and serves on the CPU."""
    run = repro_torch.serve(repro_torch.ServeConfig(
        arch=LLAMA4, smoke=True, quantize="w8a8", kv_bits=8, device="cpu",
        slots=2, trace=3, prompt_len=10, gen_len=4, prefill_chunk=4))
    out = capsys.readouterr().out
    assert "llama4-scout-17b-a16e-smoke" in out and "kv cache: int8" in out
    assert len(run.results) == 3
    assert all(r.status == "ok" for r in run.results.values())
