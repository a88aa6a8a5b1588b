"""The port's decode attention and the two decode paths that reach it,
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU as its own tests run it (its ``ref`` and ``xla`` oracles).
Tolerances:

  * ``kv_attention_ref`` (the port's plain version, the blocked online
    softmax) against JAX ``kv_attention_ref``: float32 within atol 1e-6
    (the same block order; einsum sums in other orders); a fully masked row
    exactly 0 in both.
  * against JAX ``kv_attention_xla`` (plain softmax, scales folded at score
    granularity): rtol 1e-5 + atol 1e-6; with ``v_err`` against
    ``kv_attention_xla(v_err=...)``.
  * ``append_quantize(cache_verr=...)`` bit-equal to JAX, payload, scales
    and V error means.
  * the smoke model with ``REPRO_FUSED_DECODE=0`` (set with ``monkeypatch``
    for both packages) against JAX unfused: logits within atol 1e-5, as the
    fused path's test (``test_torch_model.py``); the port's fused and
    unfused logits bit-equal.
  * with ``kv_bias_correct``: the ``v_err`` leaf exists, logits within atol
    1e-5 of JAX's, and the JAX test's bound of 0.08 (relative to the largest
    logit) against the float forward holds. The cache's ``v_err`` is within
    atol 1e-6 of the JAX model's, not bit-equal: under ``jit`` XLA contracts
    ``v_q · v_s − v`` into one FMA, so the jitted JAX model's means differ
    from its own eager op's (w8a8: measured max 4.9e-8 at token seed 0),
    and under w8a16 the V projection itself rounds differently (measured max
    5.2e-7).
  * the engine, unfused and with ``kv_bias_correct``: tokens, ticks and
    stats equal to the JAX engine's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro
from repro.configs import get_config as jax_get_config
from repro.kernels.kv_attention.ops import append_quantize as jax_append
from repro.kernels.kv_attention.ops import quantize_kv as jax_quantize_kv
from repro.kernels.kv_attention.ref import kv_attention_ref as jax_kv_ref
from repro.kernels.kv_attention.ref import kv_attention_xla
from repro.models import build_model as jax_build_model
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import synthetic_trace as jax_synthetic_trace

from _torch_port import jax_to_numpy
from repro_torch import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.kv_attention import (
    append_quantize,
    kv_attention,
    kv_attention_ref,
    quantize_kv,
)
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine, synthetic_trace
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b"

# (B, Hq, Hkv, hd, S, blk, fully masked row)
CASES = {
    "S33-blk32": (3, 4, 2, 16, 33, 32, False),
    "S-below-blk": (2, 4, 2, 16, 20, 512, False),
    "gqa4": (2, 8, 2, 16, 48, 16, False),
    "masked-row": (3, 4, 2, 16, 40, 16, True),
}


def _inputs(B, Hq, Hkv, hd, S, masked_row, seed=0):
    """numpy q, K/V payload and scales (zero past each row's length), and
    V error means zero where the scales are, as the decode route passes
    them."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hq, hd).astype(np.float32)
    kq = rng.randint(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    vq = rng.randint(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    ks = (rng.rand(B, S, Hkv) * 0.02).astype(np.float32)
    vs = (rng.rand(B, S, Hkv) * 0.02).astype(np.float32)
    lens = rng.randint(1, S + 1, B)
    lens[0] = S
    if masked_row:
        lens[-1] = 0
    live = (np.arange(S)[None, :] < lens[:, None])[..., None]
    ks, vs = ks * live, vs * live
    verr = (rng.randn(B, S, Hkv) * 1e-3).astype(np.float32) * live
    return q, kq, ks, vq, vs, verr


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_ref(case):
    B, Hq, Hkv, hd, S, blk, masked = CASES[case]
    q, kq, ks, vq, vs, _ = _inputs(B, Hq, Hkv, hd, S, masked)
    want = np.asarray(jax_kv_ref(*map(jnp.asarray, (q, kq, ks, vq, vs)),
                                 blk=blk))
    got = kv_attention_ref(*_torch(q, kq, ks, vq, vs), blk=blk).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if masked:
        assert not got[-1].any() and not want[-1].any()


@pytest.mark.parametrize("with_err", [False, True], ids=["plain", "v_err"])
@pytest.mark.parametrize("case", list(CASES))
def test_op_matches_jax_xla(case, with_err):
    """The public op on a CPU tensor (the plain version) against the JAX
    package's serving XLA path, with and without the V bias correction."""
    B, Hq, Hkv, hd, S, blk, masked = CASES[case]
    q, kq, ks, vq, vs, verr = _inputs(B, Hq, Hkv, hd, S, masked)
    ve = verr if with_err else None
    want = np.asarray(kv_attention_xla(
        *map(jnp.asarray, (q, kq, ks, vq, vs)),
        v_err=None if ve is None else jnp.asarray(ve)))
    reset_launch_counts()
    got = kv_attention(*_torch(q, kq, ks, vq, vs), blk=blk,
                       v_err=None if ve is None else torch.from_numpy(ve))
    assert launch_counts()["kv_attention"] == 0          # the CPU: no kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if with_err:
        assert not np.allclose(got.numpy(), kv_attention_ref(
            *_torch(q, kq, ks, vq, vs), blk=blk).numpy(), rtol=0, atol=1e-7)


def test_v_bias_correction_reduces_mean_error():
    """As ``tests/test_kv_attention_kernel.py``: with V biased away from 0,
    round-to-nearest leaves a per-token mean error that the correction
    removes, so the corrected output lies closer to float attention."""
    B, S, Hkv, hd = 2, 64, 2, 32
    rng = np.random.RandomState(13)
    q = torch.from_numpy(rng.randn(B, Hkv, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S, Hkv, hd).astype(np.float32))
    v = torch.from_numpy((rng.randn(B, S, Hkv, hd) + 0.8).astype(np.float32))
    k_q, k_s = quantize_kv(k)
    v_q, v_s = quantize_kv(v)
    v_err = (v_q.float() * v_s[..., None] - v).mean(-1)
    p = torch.softmax(torch.einsum("bnd,bsnd->bns", q, k) / hd ** 0.5, -1)
    fp = torch.einsum("bns,bsnd->bnd", p, v)
    plain = kv_attention(q, k_q, k_s, v_q, v_s)
    corrected = kv_attention(q, k_q, k_s, v_q, v_s, v_err=v_err)
    err_plain = float((plain - fp).abs().mean())
    err_corr = float((corrected - fp).abs().mean())
    assert err_corr <= err_plain
    assert not torch.allclose(plain, corrected)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("per_slot", [True, False], ids=["per-slot", "shared"])
def test_append_quantize_with_verr_bit_equal_to_jax(per_slot, hd):
    B, T, S, Hkv = 3, 2, 12, 2
    rng = np.random.RandomState(hd)
    kn = (rng.randn(B, T, Hkv, hd) * 2).astype(np.float32)
    vn = (rng.randn(B, T, Hkv, hd) + 0.3).astype(np.float32)
    idx = (rng.randint(0, S, (B, T)) if per_slot
           else np.array([4, 9])).astype(np.int64)
    if per_slot:
        idx[:, 1] = (idx[:, 0] + 1) % S
    zeros = [np.zeros((B, S, Hkv, hd), np.int8), np.zeros((B, S, Hkv), np.float32),
             np.zeros((B, S, Hkv, hd), np.int8), np.zeros((B, S, Hkv), np.float32),
             np.zeros((B, S, Hkv), np.float32)]
    want = jax_append(*map(jnp.asarray, zeros[:4]), jnp.asarray(kn),
                      jnp.asarray(vn), jnp.asarray(idx.astype(np.int32)),
                      cache_verr=jnp.asarray(zeros[4]))
    leaves = _torch(*zeros)
    got = append_quantize(*leaves[:4], *_torch(kn, vn), torch.from_numpy(idx),
                          cache_verr=leaves[4])
    assert len(got) == 5 and all(g is t for g, t in zip(got, leaves))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.abs(leaves[4].numpy()).max() > 0
    np.testing.assert_array_equal(quantize_kv(torch.from_numpy(vn))[0].numpy(),
                                  np.asarray(jax_quantize_kv(jnp.asarray(vn))[0]))


# ------------------------------------------------------------ model paths

RECIPES = ["serve-w8a8-kv8", "serve-w8a16-kv8"]


@functools.lru_cache(maxsize=None)
def _quantized(recipe):
    return repro.quantize(f"{ARCH}-smoke", recipe=recipe)


def _pair(recipe, bias_correct=False):
    """(JAX model, JAX params, port model, port params) for ``recipe``'s
    weights, both models with ``kv_bias_correct`` as given."""
    qm = _quantized(recipe)
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               kv_bias_correct=bias_correct)
    tcfg = dataclasses.replace(get_config(f"{ARCH}-smoke"),
                               kv_bias_correct=bias_correct)
    return (jax_build_model(jcfg), qm.params, build_model(tcfg),
            from_jax_numpy(jax_to_numpy(qm.params), tcfg, device="cpu"))


def _roll_torch(tm, tp, toks, prefill=8):
    tc = tm.init_cache(toks.shape[0], 32, device="cpu", kv_bits=8)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :prefill]).long(), tc)
    out = [tl]
    for t in range(prefill, toks.shape[1]):
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                tc)
        out.append(tl)
    return torch.stack(out).numpy(), tc


def _roll_jax(jm, jp, toks, prefill=8):
    jc = jm.init_cache(toks.shape[0], 32, dtype=jnp.float32, per_slot=True,
                       kv_bits=8)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :prefill]), jc)
    out = [np.asarray(jl)]
    for t in range(prefill, toks.shape[1]):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        out.append(np.asarray(jl))
    return np.stack(out), jc


def _tokens(seed=0, B=2, T=24):
    return np.random.RandomState(seed).randint(0, 256, (B, T)).astype(np.int32)


@pytest.mark.parametrize("recipe", RECIPES)
def test_unfused_model_matches_jax_unfused(recipe, monkeypatch):
    """REPRO_FUSED_DECODE=0 in both packages: prefill and 16 decode steps'
    logits within atol 1e-5 of JAX's, greedy tokens equal, and the port's
    unfused logits bit-equal to its fused ones."""
    jm, jp, tm, tp = _pair(recipe)
    toks = _tokens()
    fused, _ = _roll_torch(tm, tp, toks)
    monkeypatch.setenv("REPRO_FUSED_DECODE", "0")
    lt, tc = _roll_torch(tm, tp, toks)
    lj, jc = _roll_jax(jm, jp, toks)
    np.testing.assert_array_equal(lt, fused)
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    np.testing.assert_array_equal(tc["v"].numpy(), np.asarray(jc["v"]))


def test_decode_routes_by_the_flag_and_the_cache(monkeypatch):
    """The fused op runs only when the flag is on and the cache has no
    v_err; else kv_attention_decode, with its quantize_act for a W8A8 wo."""
    from repro_torch.models import layers

    seen = []
    for name in ("fused_decode", "kv_attention_decode"):
        real = getattr(layers, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(layers, name, spy)
    toks = _tokens(T=10)
    for flag, bias_correct, want in (("1", False, "fused_decode"),
                                     ("off", False, "kv_attention_decode"),
                                     ("1", True, "kv_attention_decode")):
        monkeypatch.setenv("REPRO_FUSED_DECODE", flag)
        _, _, tm, tp = _pair("serve-w8a8-kv8", bias_correct)
        seen.clear()
        _roll_torch(tm, tp, toks)
        assert seen == [want] * (2 * tm.cfg.n_layers), (flag, bias_correct)


@pytest.mark.parametrize("recipe", RECIPES)
def test_bias_corrected_model_matches_jax(recipe):
    """kv_bias_correct: the v_err leaf exists and fills, prefill and decode
    logits within atol 1e-5 of JAX's with the same flag, greedy tokens
    equal."""
    jm, jp, tm, tp = _pair(recipe, bias_correct=True)
    toks = _tokens()
    lt, tc = _roll_torch(tm, tp, toks)
    lj, jc = _roll_jax(jm, jp, toks)
    assert "v_err" in tc and tc["v_err"].shape == tc["v_scale"].shape
    assert float(tc["v_err"].abs().max()) > 0
    np.testing.assert_allclose(tc["v_err"].numpy(), np.asarray(jc["v_err"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)


def test_bias_corrected_decode_stays_near_the_float_forward():
    """As ``tests/test_kv_cache_int8.py``: float32 weights, the int8 cache
    with the correction, decode logits within 0.08 of the largest float
    logit."""
    cfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                              kv_cache_bits=8, kv_bias_correct=True)
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(f"{ARCH}-smoke"),
                               kv_bias_correct=True)
    tm = build_model(tcfg)
    tp = from_jax_numpy(jax_to_numpy(jp), tcfg, device="cpu")
    toks = torch.tensor(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, 12), 0, cfg.vocab_size)), dtype=torch.long)
    full = tm.apply(tp, toks)
    cache = tm.init_cache(2, 24, device="cpu", kv_bits=8)
    assert "v_err" in cache
    _, cache = tm.prefill(tp, toks[:, :-1], cache)
    ld, _ = tm.decode_step(tp, toks[:, -1:], cache)
    denom = float(full[:, -1].abs().max()) + 1e-9
    assert float((ld - full[:, -1]).abs().max()) / denom < 0.08


ENGINE = dict(num_slots=4, max_len=64, prefill_chunk=8)
TRACE = dict(vocab_size=256, prompt_lens=(3, 24), gen_lens=(1, 16),
             mean_interarrival=0.7)


@pytest.mark.parametrize("mode", ["unfused", "kv_bias_correct"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_engine_matches_jax_engine(recipe, mode, monkeypatch):
    """The stepwise engine on synthetic_trace seed 0: per-request tokens,
    admission and finish ticks and the stats counters equal the JAX
    engine's (its default CPU tier), unfused or with the V bias
    correction."""
    if mode == "unfused":
        monkeypatch.setenv("REPRO_FUSED_DECODE", "0")
    jm, jp, tm, tp = _pair(recipe, bias_correct=mode == "kv_bias_correct")
    jeng = JaxServingEngine(jm, jp, jm.cfg, fast=False, kv_bits=8, **ENGINE)
    jres = jeng.run(jax_synthetic_trace(0, 10, **TRACE))
    eng = ServingEngine(tm, tp, tm.cfg, device="cpu", fast=False, kv_bits=8,
                        **ENGINE)
    assert ("v_err" in eng.pool.cache) == (mode == "kv_bias_correct")
    res = eng.run(synthetic_trace(0, 10, **TRACE))
    assert sorted(res) == sorted(jres) == list(range(10))
    for rid in jres:
        assert res[rid].tokens == jres[rid].tokens, rid
        assert res[rid].admitted_at == jres[rid].admitted_at
        assert res[rid].finished_at == jres[rid].finished_at
        assert res[rid].status == jres[rid].status == "ok"
    for k in ("decode_steps", "decode_dispatches", "prefill_chunks",
              "prefill_dispatches", "host_syncs", "generated_tokens",
              "occupancy_sum", "engine_steps", "shed", "quarantined"):
        assert eng.stats[k] == jeng.stats[k], k
