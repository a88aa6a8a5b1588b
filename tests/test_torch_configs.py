"""The five dense decoders the port serves — qwen2-0.5b, yi-34b,
mistral-nemo-12b, gemma-7b (GeGLU, head_dim 256) and chameleon-34b (family
``vlm``, early fusion, with ``qk_norm``) — against the JAX package, at
smoke size in float32 on the same weights.

Per arch: the config's fields equal the reference's, the eval forward's
logits and ``loss`` within ``FWD_TOL`` (float32 summation order only:
measured ≤ 5.7e-6 absolute on the logits, ≤ 1e-7 relative on the loss),
the DFQ plan's ops and sites equal (no
``QKPairOp`` under ``qk_norm``), ``input_specs`` / ``cache_specs`` complete
and shaped as the reference's, ``param_count`` inside
``tests/test_models_smoke.py``'s public ranges, and the W8A16 deployment
served over the fp cache with the JAX engine's tokens and ticks. The plain
``gelu`` and ``relu`` MLPs ride along on qwen2's smoke geometry.
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
from repro.models.model import input_specs as jax_input_specs
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import synthetic_trace as jax_synthetic_trace

import torch

import repro_torch
from repro_torch.configs import get_config, list_archs
from repro_torch.models import (
    SHAPE_BY_NAME,
    build_model,
    cache_specs,
    input_specs,
    shape_applicable,
)
from repro_torch.serving import ServingEngine, synthetic_trace
from repro_torch.weights import from_jax_numpy

ARCHS = ["qwen2-0.5b", "yi-34b", "mistral-nemo-12b", "gemma-7b",
         "chameleon-34b"]
# (arch, act override) — the plain MLPs have no config of their own
FORWARD_CASES = [(a, None) for a in ARCHS] + [("qwen2-0.5b", "gelu"),
                                              ("qwen2-0.5b", "relu")]
FWD_TOL = 1e-5
PUBLIC_SIZES = {"qwen2-0.5b": (0.35e9, 0.8e9), "yi-34b": (30e9, 38e9),
                "mistral-nemo-12b": (10e9, 14e9), "gemma-7b": (7e9, 10e9),
                "chameleon-34b": (30e9, 40e9)}


def _pair(arch, act=None, seed=0):
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    if act is not None:
        jcfg = dataclasses.replace(jcfg, act=act)
        cfg = dataclasses.replace(cfg, act=act)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                                    device="cpu")


def test_registry_lists_the_five_dense_archs():
    """The five dense archs, beside the two MoE archs
    (tests/test_torch_moe.py), the SSM and hybrid archs
    (tests/test_torch_ssm.py) and the encoder-decoder
    (tests/test_torch_encdec.py): the JAX package's registry."""
    from repro.configs import list_archs as jax_list_archs

    assert list_archs() == sorted(ARCHS + [
        "mixtral-8x22b", "llama4-scout-17b-a16e", "mamba2-2.7b",
        "zamba2-2.7b", "whisper-tiny"]) == jax_list_archs()
    assert [a for a in list_archs()
            if get_config(a).family in ("dense", "vlm")] == sorted(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch):
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                                 smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("arch,act", FORWARD_CASES)
def test_smoke_forward_and_loss_match_jax(arch, act):
    jm, jp, tm, tp = _pair(arch, act)
    if arch == "chameleon-34b":
        assert "q_norm" in tp["blocks"]["attn"]
    if act in ("gelu", "relu"):
        assert "wg" not in tp["blocks"]["mlp"]
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 256, (2, 64)).astype(np.int32)
    labels = rng.randint(0, 256, (2, 64)).astype(np.int32)
    jl, _ = jm.apply(jp, jnp.asarray(toks))
    tl = tm.apply(tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_TOL,
                               rtol=0)
    batch = {"tokens": toks, "labels": labels}
    jloss = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    tloss = tm.loss(tp, {k: torch.from_numpy(v).long()
                         for k, v in batch.items()})
    assert tloss.dtype == torch.float32 and tloss.shape == ()
    assert abs(float(tloss) - jloss) <= FWD_TOL * abs(jloss)


def test_loss_refuses_a_length_off_the_chunk():
    """T not a multiple of ``logit_chunk`` raises in both packages (the
    JAX ``loss``'s reshape) instead of dropping the tail positions."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               logit_chunk=16)
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              logit_chunk=16)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm, tp = build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                              device="cpu")
    toks = np.random.RandomState(2).randint(0, 256, (2, 40)).astype(np.int32)
    with pytest.raises(TypeError):
        jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(toks).long()}
    with pytest.raises(ValueError, match="not a multiple of logit_chunk 16"):
        tm.loss(tp, batch)
    # a multiple of the chunk still matches the reference
    jloss = float(jm.loss(jp, {"tokens": jnp.asarray(toks[:, :32]),
                               "labels": jnp.asarray(toks[:, :32])}))
    tloss = float(tm.loss(tp, {k: v[:, :32] for k, v in batch.items()}))
    assert abs(tloss - jloss) <= FWD_TOL * abs(jloss)


def _fields(op):
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in vars(op).items() if v is not None}


@pytest.mark.parametrize("arch,act", FORWARD_CASES)
def test_dfq_plan_equals_the_reference(arch, act):
    jm, _, tm, _ = _pair(arch, act)
    jplan, tplan = jm.dfq_plan(), tm.dfq_plan()
    assert [type(o).__name__ for o in tplan.ops] == [
        type(o).__name__ for o in jplan.ops]
    for t, j in zip(tplan.ops, jplan.ops):
        assert _fields(t) == _fields(j), type(t).__name__
    assert [dataclasses.astuple(s) for s in tplan.sites] == [
        dataclasses.astuple(s) for s in jplan.sites]
    has_qk = any(type(o).__name__ == "QKPairOp" for o in tplan.ops)
    assert has_qk == (not tm.cfg.qk_norm)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_complete(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SHAPE_BY_NAME[name]
        specs = input_specs(cfg, shape)
        want = jax_input_specs(jcfg, shape)
        assert sorted(specs) == sorted(want)
        for k, v in specs.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
    cache = cache_specs(cfg, SHAPE_BY_NAME["decode_32k"])
    L, B, S = cfg.n_layers, 128, 32768
    assert set(cache) == {"k", "v", "kpos", "pos"}
    assert tuple(cache["k"].shape) == (L, B, S, cfg.n_kv_heads, cfg.head_dim)
    assert cache["k"].dtype == torch.bfloat16 and cache["k"].device.type == "meta"
    ok, why = shape_applicable(cfg, SHAPE_BY_NAME["long_500k"])
    assert not ok and "full-attention" in why
    assert shape_applicable(cfg, SHAPE_BY_NAME["decode_32k"]) == (True, "")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_within_public_sizes(arch):
    lo, hi = PUBLIC_SIZES[arch]
    n = get_config(arch).param_count()
    assert lo <= n <= hi
    assert n == jax_get_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_serves_w8a16_over_the_fp_cache_as_jax(arch):
    """The reference's default deployment at smoke size: serve-w8a16 from
    the JAX package's quantization, the stepwise engine over the fp pool
    against the JAX engine — every token, admission and finish tick."""
    jm, jp, tm, _ = _pair(arch)
    jq = repro.quantize(jm, params=jp, recipe="serve-w8a16")
    tp = from_jax_numpy(jax_to_numpy(jq.params), tm.cfg, device="cpu")
    kw = dict(num_slots=3, max_len=48, prefill_chunk=8)
    trace = dict(vocab_size=256, prompt_lens=(3, 20), gen_lens=(1, 10),
                 mean_interarrival=0.8)
    jres = JaxServingEngine(jm, jq.params, jq.cfg, fast=False, kv_bits=16,
                            **kw).run(jax_synthetic_trace(0, 6, **trace))
    eng = ServingEngine(tm, tp, tm.cfg, device="cpu", fast=False, **kw)
    assert eng.kv_bits == 16
    res = eng.run(synthetic_trace(0, 6, **trace))
    for rid, j in jres.items():
        assert res[rid].tokens == [int(t) for t in j.tokens], rid
        assert res[rid].finished_at == j.finished_at, rid


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_kv8_entry_point_on_cpu(arch):
    """``repro_torch.serve --arch <arch> --smoke --quantize w8a8 --kv-bits
    8`` (serve-w8a8-kv8: the int8 cache, the fused decode's plain version)
    serves every request with finite logits on the CPU."""
    run = repro_torch.serve(repro_torch.ServeConfig(
        arch=arch, smoke=True, device="cpu", quantize="w8a8", kv_bits=8,
        slots=2, trace=3, prompt_len=10, gen_len=4, prefill_chunk=4))
    assert run.kv_bits == 8 and len(run.results) == 3
    assert all(r.status == "ok" for r in run.results.values())
