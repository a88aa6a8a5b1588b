"""The fp (16-bit) KV cache — the JAX launcher's default deployment — and
the whole-batch cache, against the JAX package.

At smoke size in float32: prefill + teacher-forced decode over the fp
cache against JAX's (fp, W8A16 and W8A8 weights), the stepwise engine
against the JAX engine (``kv_bits=16``), the fast path against the
stepwise path, the whole-batch cache (``per_slot=False``) against the full
forward, kv8 against fp as ``tests/test_serving_kv8.py`` states it, the
launcher's ``--kv-bits 16`` and ``--quantize none``, and an artifact
recorded at bits 16 loaded by both packages.

The fp cache is plain maths in both packages (a write of the new rows,
then softmax attention over the cache), so the logits differ only by
float32 summation order: measured ≤ 7e-7 here, held to ``LOGIT_TOL``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro
from _torch_port import jax_to_numpy
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import synthetic_trace as jax_synthetic_trace

import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.dispatch import ENV_VAR
from repro_torch.models import build_model
from repro_torch.pipeline import QuantizedModel
from repro_torch.serving import CachePool, ServingEngine, synthetic_trace
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b-smoke"
LOGIT_TOL = 1e-4
ENGINE = dict(num_slots=4, max_len=64, prefill_chunk=8)
TRACE = dict(vocab_size=256, prompt_lens=(3, 24), gen_lens=(1, 16),
             mean_interarrival=0.7)


@pytest.fixture(scope="module", params=["none", "serve-w8a16", "serve-w8a8"])
def pair(request):
    """(JAX model, JAX params, port model, port params) over the fp cache:
    the fp32 smoke init, or its serve-<scheme> quantization (no kv_cache
    stage: the fp cache)."""
    jm = jax_build_model(jax_get_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    if request.param != "none":
        qm = repro.quantize(jm, params=jp, recipe=request.param)
        assert qm.cfg.kv_cache_bits == 16
        jp = qm.params
    cfg = get_config(ARCH)
    return jm, jp, build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                                    device="cpu")


def _rolls(jm, jp, tm, tp, toks, per_slot=True, prefill=8):
    jc = jm.init_cache(toks.shape[0], 32, dtype=jnp.float32,
                       per_slot=per_slot, kv_bits=16)
    tc = tm.init_cache(toks.shape[0], 32, device="cpu", per_slot=per_slot,
                       kv_bits=16)
    assert set(tc) == set(jc) == {"k", "v", "kpos", "pos"}
    assert tc["k"].dtype == torch.float32
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :prefill]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :prefill]).long(), tc)
    js, ts = [np.asarray(jl)], [tl.numpy()]
    for t in range(prefill, toks.shape[1]):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                tc)
        js.append(np.asarray(jl))
        ts.append(tl.numpy())
    return np.stack(js), np.stack(ts), jc, tc


@pytest.mark.parametrize("per_slot", [True, False])
def test_fp_cache_prefill_decode_matches_jax(pair, per_slot):
    jm, jp, tm, tp = pair
    toks = np.random.RandomState(3).randint(0, 256, (3, 20)).astype(np.int32)
    jl, tl, jc, tc = _rolls(jm, jp, tm, tp, toks, per_slot=per_slot)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-5, rtol=0)


def test_whole_batch_cache_matches_the_full_forward(pair):
    """``per_slot=False``: prefill + one decode step give the full
    forward's last two logits (``test_models_smoke.py``'s check)."""
    _, _, tm, tp = pair
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 256, (2, 12), generator=gen)
    full = tm.apply(tp, toks)
    cache = tm.init_cache(2, 32, device="cpu", per_slot=False)
    assert cache["pos"].shape == () and cache["kpos"].shape == (32,)
    lp, cache = tm.prefill(tp, toks[:, :-1], cache)
    ld, cache = tm.decode_step(tp, toks[:, -1:], cache)
    assert int(cache["pos"]) == 12
    torch.testing.assert_close(lp, full[:, -2], atol=LOGIT_TOL, rtol=0)
    torch.testing.assert_close(ld, full[:, -1], atol=LOGIT_TOL, rtol=0)


def test_whole_batch_int8_cache_matches_jax(pair):
    """The int8 cache in its whole-batch form (shared ring offsets through
    the fused decode and append_quantize) against JAX's."""
    jm, jp, tm, tp = pair
    toks = np.random.RandomState(5).randint(0, 256, (2, 14)).astype(np.int32)
    jc = jm.init_cache(2, 32, dtype=jnp.float32, kv_bits=8)
    tc = tm.init_cache(2, 32, device="cpu", per_slot=False, kv_bits=8)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :6]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :6]).long(), tc)
    for t in range(6, 14):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                tc)
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)


def test_engine_matches_jax_engine_over_the_fp_cache(pair):
    """The stepwise engine over the fp pool: tokens, admission and finish
    ticks equal the JAX engine's (``kv_bits=16``); no kernel launches."""
    jm, jp, tm, tp = pair
    jeng = JaxServingEngine(jm, jp, jm.cfg, fast=False, kv_bits=16, **ENGINE)
    jres = jeng.run(jax_synthetic_trace(0, 10, **TRACE))
    reset_launch_counts()
    eng = ServingEngine(tm, tp, tm.cfg, device="cpu", fast=False, **ENGINE)
    assert eng.kv_bits == 16 and "k_scale" not in eng.pool.cache
    res = eng.run(synthetic_trace(0, 10, **TRACE))
    assert set(launch_counts().values()) <= {0}
    assert sorted(res) == sorted(jres)
    for rid, j in jres.items():
        assert res[rid].tokens == [int(t) for t in j.tokens], rid
        assert (res[rid].admitted_at, res[rid].finished_at) == (
            j.admitted_at, j.finished_at), rid


@pytest.mark.parametrize("horizon", [1, 3, 8])
def test_fast_path_equals_stepwise_over_the_fp_cache(pair, horizon):
    _, _, tm, tp = pair
    fast = ServingEngine(tm, tp, tm.cfg, device="cpu", decode_horizon=horizon,
                         **ENGINE)
    warm = fast.warmup()
    assert warm["decode_steps"] > 0
    res = fast.run(synthetic_trace(1, 8, **TRACE))
    ref = ServingEngine(tm, tp, tm.cfg, device="cpu", fast=False,
                        **ENGINE).run(synthetic_trace(1, 8, **TRACE))
    for rid, r in ref.items():
        assert res[rid].tokens == r.tokens, rid
        assert res[rid].finished_at == r.finished_at, rid
    assert fast.pool.all_free()


def test_kv8_vs_fp_greedy_agreement_and_sqnr():
    """``tests/test_serving_kv8.py``'s statement on the port: teacher-forced
    logits through the int8 cache stay close to the fp cache's (logits
    SQNR > 25 dB, greedy agreement >= 0.8), and the engines agree on the
    first generated token of >= 90 % of a mixed trace."""
    cfg = get_config(ARCH)
    jm = jax_build_model(jax_get_config(ARCH))
    model = build_model(cfg)
    params = from_jax_numpy(jax_to_numpy(jm.init(jax.random.PRNGKey(0))),
                            cfg, device="cpu")
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(2), (2, 20), 0, cfg.vocab_size))).long()

    def roll(kv_bits):
        cache = model.init_cache(2, 24, device="cpu", kv_bits=kv_bits)
        lg, cache = model.prefill(params, toks[:, :8], cache)
        outs = [lg]
        for t in range(8, 20):
            lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
            outs.append(lg)
        return torch.stack(outs)

    lf, l8 = roll(16), roll(8)
    sqnr = 10 * np.log10(float((lf ** 2).sum() / ((lf - l8) ** 2).sum()))
    agree = float((lf.argmax(-1) == l8.argmax(-1)).float().mean())
    assert sqnr > 25.0, f"kv8 logits SQNR {sqnr:.1f} dB"
    assert agree >= 0.8, f"kv8 greedy agreement {agree:.2f}"
    trace = synthetic_trace(3, 12, vocab_size=cfg.vocab_size,
                            prompt_lens=(2, 12), gen_lens=(1, 6),
                            mean_interarrival=0.3)
    kw = dict(num_slots=4, max_len=32, prefill_chunk=8, device="cpu")
    fp = ServingEngine(model, params, cfg, **kw).run(
        [dataclasses.replace(r) for r in trace])
    k8 = ServingEngine(model, params, cfg, kv_bits=8, **kw).run(
        [dataclasses.replace(r) for r in trace])
    agree = sum(fp[r.rid].tokens[0] == k8[r.rid].tokens[0] for r in trace)
    assert agree >= 0.9 * len(trace), f"{agree}/{len(trace)} first tokens"


def test_pool_holds_the_compute_dtype_and_counts_its_bytes():
    """The fp pool's payload is in the compute dtype; bytes/slot against the
    int8 pool is 4·hd/(hd + 4) in float32, 2·hd/(hd + 4) in bfloat16."""
    cfg = get_config(ARCH)
    hd = cfg.head_dim
    for dtype, ratio in (("float32", 4 * hd / (hd + 4)),
                         ("bfloat16", 2 * hd / (hd + 4))):
        model = build_model(dataclasses.replace(cfg, dtype=dtype))
        fp = CachePool(model, 2, 16, device="cpu")
        k8 = CachePool(model, 2, 16, device="cpu", kv_bits=8)
        assert fp.kv_bits == 16 and k8.kv_bits == 8
        assert fp.cache["k"].dtype == getattr(torch, dtype)
        assert set(fp.cache) == {"k", "v", "kpos", "pos"}
        assert fp.bytes_per_slot() / k8.bytes_per_slot() == pytest.approx(ratio)


def test_serve_fp_cache_and_unquantized_on_the_cpu(capsys):
    """``serve --kv-bits 16`` (the default recipe, serve-w8a16) and
    ``--quantize none`` (fp32 weights) serve over the fp cache; --kv-bits 8
    selects the -kv8 recipe; the report names the cache."""
    common = dict(arch="qwen2-0.5b", smoke=True, device="cpu", slots=2,
                  trace=3, prompt_len=10, gen_len=4, prefill_chunk=4)
    run = repro_torch.serve(repro_torch.ServeConfig(kv_bits=16, **common))
    out = capsys.readouterr().out
    assert "with recipe 'serve-w8a16'" in out and "kv cache: fp" in out
    assert run.kv_bits == 16 and len(run.results) == 3
    run = repro_torch.serve(repro_torch.ServeConfig(quantize="none", **common))
    out = capsys.readouterr().out
    assert "unquantized" in out and "kv cache: fp" in out
    assert run.report == [] and len(run.results) == 3
    assert all(len(r.tokens) >= 1 for r in run.results.values())
    run = repro_torch.serve(repro_torch.ServeConfig(quantize="none", kv_bits=8,
                                                    reference=True, **common))
    assert run.kv_bits == 8 and "kv cache: int8" in capsys.readouterr().out
    run = repro_torch.serve(repro_torch.ServeConfig(quantize="w8a8", kv_bits=8,
                                                    **common))
    assert "with recipe 'serve-w8a8-kv8'" in capsys.readouterr().out


def test_explicit_torch_tier_serves_the_default_tokens(capsys, monkeypatch):
    """``REPRO_KERNEL_BACKEND=torch`` resolves every op at the plain tier:
    on the CPU the same tokens as the device's default. The launcher
    prints the tier it resolved."""
    common = dict(arch="qwen2-0.5b", smoke=True, device="cpu", slots=2,
                  trace=3, prompt_len=10, gen_len=4, prefill_chunk=4,
                  quantize="w8a8", kv_bits=8)
    monkeypatch.delenv(ENV_VAR, raising=False)
    a = repro_torch.serve(repro_torch.ServeConfig(**common))
    assert "kernel tier: torch" in capsys.readouterr().out
    monkeypatch.setenv(ENV_VAR, "torch")
    b = repro_torch.serve(repro_torch.ServeConfig(**common))
    assert "kernel tier: torch" in capsys.readouterr().out
    assert {k: r.tokens for k, r in a.results.items()} == {
        k: r.tokens for k, r in b.results.items()}


@pytest.mark.parametrize("recipe", ["serve-w8a16", "serve-w8a8"])
def test_artifact_at_bits_16_round_trips_through_both_packages(tmp_path,
                                                               recipe):
    """A port artifact with no kv_cache stage records kv_cache_bits 16; JAX
    loads it and decodes over its fp cache to the port's logits; a JAX
    artifact at 16 loads in the port at 16 and serves through --load."""
    cfg = get_config(ARCH)
    jm = jax_build_model(jax_get_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    qm = repro_torch.quantize(ARCH, from_jax_numpy(jax_to_numpy(jp), cfg,
                                                   device="cpu"),
                              recipe=recipe, device="cpu")
    assert qm.kv_bits == qm.cfg.kv_cache_bits == 16
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    qm.save(port_dir)
    jq = repro.QuantizedModel.load(port_dir)
    assert jq.cfg.kv_cache_bits == 16
    toks = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(np.int32)
    jl, tl, _, _ = _rolls(jq.model, jq.params, qm.model, qm.params, toks)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)
    repro.quantize(jm, params=jp, recipe=recipe).save(jax_dir)
    loaded = QuantizedModel.load(jax_dir, device="cpu")
    assert loaded.kv_bits == 16 and loaded.cfg == qm.cfg
    run = repro_torch.serve(repro_torch.ServeConfig(
        load=jax_dir, device="cpu", trace=2, prompt_len=8, gen_len=4))
    assert run.kv_bits == 16 and len(run.results) == 2


def test_serve_cuts_the_depth(capsys):
    """``--layers N`` serves the arch's first N layers at its widths (the
    card-size cut of a full-width run); it refuses a --load artifact."""
    run = repro_torch.serve(repro_torch.ServeConfig(
        arch="mistral-nemo-12b", smoke=True, layers=1, device="cpu",
        slots=2, trace=2, prompt_len=8, gen_len=4, prefill_chunk=4))
    assert len(run.results) == 2
    assert "mistral-nemo-12b-smoke (1 layers)" in capsys.readouterr().out
    with pytest.raises(repro_torch.ServeConfigError, match="layers"):
        repro_torch.ServeConfig(layers=0).validate()
    with pytest.raises(repro_torch.ServeConfigError, match="as saved"):
        repro_torch.ServeConfig(layers=2, load="/nonexistent").validate()
