"""The port's quantization pipeline (``repro_torch.pipeline``) against the
JAX package's.

``repro_torch.quantize("qwen2-0.5b-smoke", params, recipe=r,
device="cpu")`` runs on the same hostile weights as ``repro.quantize`` (the
JAX init through ``hostile_rescale``, with random norm gains and qkv / o
biases, carried across through numpy), for both serving recipes. The
int8 payloads and their scales must be bit-equal, and so must every fp
leaf but the output bias ``bo``: its value-bias shift is a matrix product
summed in XLA's order on one side and PyTorch's on the other, so it is
held to the dot-product bound ``n · 2⁻²³ · (|c| @ |wo|)`` plus one ulp
(the bound and the measured maximum are in ``test_torch_dfq.py``; here
the same leaf is held to 2e-6 absolute, measured 4.8e-7). The stage
records must match, the per-site SQNR within 1e-4 dB.

The error paths mirror ``tests/test_pipeline.py``; a recipe naming a stage
the port lacks raises ``PipelineError`` naming it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro.pipeline as jax_pipeline
from _torch_port import hostile_jax_params, jax_to_numpy

import repro_torch
from repro_torch import get_config
from repro_torch.pipeline import (
    NOT_PORTED,
    PipelineError,
    Recipe,
    RecipeError,
    RecipeStep,
    list_recipes,
    list_stages,
    register_stage,
    resolve_recipe,
    unregister_stage,
)
from repro_torch.quantized import QTensor
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b-smoke"
RECIPES = ["serve-w8a16-kv8", "serve-w8a8-kv8"]


# ---------------------------------------------------------------- validation

def test_unknown_recipe_name_error():
    with pytest.raises(RecipeError, match="serve-w8a8"):
        resolve_recipe("serve-w8a9")


def test_unknown_stage_error_suggests_and_lists():
    r = Recipe("bad", (RecipeStep("clee", {}),))
    with pytest.raises(RecipeError) as e:
        r.validate()
    msg = str(e.value)
    assert "did you mean 'cle'" in msg
    assert "pack" in msg and "kv_cache" in msg    # lists the registered stages


def test_unknown_option_error_lists_allowed():
    r = Recipe("bad", (RecipeStep("pack", {"modee": "w8a16"}),))
    with pytest.raises(RecipeError, match="modee"):
        r.validate()
    with pytest.raises(RecipeError, match="mode"):
        r.validate()


def test_empty_recipe_error():
    with pytest.raises(RecipeError, match="no stages"):
        Recipe("empty", ()).validate()


def test_with_options_unknown_stage_error():
    r = resolve_recipe("serve-w8a16")
    with pytest.raises(RecipeError, match="weight_quant"):
        r.with_options({"weight_quant": {"bits": 4}})


def test_builtin_recipes_validate_and_match_jax():
    assert list_recipes() == ["serve-w8a16", "serve-w8a16-kv8", "serve-w8a8",
                              "serve-w8a8-kv8"]
    for name in list_recipes():
        r = resolve_recipe(name)
        r.validate()
        jr = jax_pipeline.resolve_recipe(name)
        assert [(s.stage, dict(s.options)) for s in r.steps] == \
               [(s.stage, dict(s.options)) for s in jr.steps]


def test_kv_cache_refuses_the_unported_fp_cache():
    """bits=16 is the JAX package's fp KV cache, which the port does not
    serve: the stage refuses it instead of recording it."""
    with pytest.raises(PipelineError, match="bits=16.*not ported yet"):
        repro_torch.quantize(ARCH, recipe=[("kv_cache", {"bits": 16})],
                             device="cpu")
    qm = repro_torch.quantize(ARCH, recipe=[("kv_cache", {"bits": 8})],
                              device="cpu")
    assert qm.kv_bits == 8


def test_config_and_cle_stage_take_only_options_the_port_reads():
    """``DFQConfig`` holds the rewrites' switches only, and the cle stage
    has no approximate-pair option: passing either raises, where it would
    otherwise be ignored."""
    from repro_torch.core import DFQConfig

    assert [f.name for f in dataclasses.fields(DFQConfig)] == [
        "cle", "cle_iterations", "bias_absorb"]
    for field in ("weight_bits", "per_channel", "bias_correct",
                  "n_sigma_absorb", "cle_include_approx_pairs"):
        with pytest.raises(TypeError, match=field):
            DFQConfig(**{field: 4})
    with pytest.raises(RecipeError, match="include_approx_pairs"):
        Recipe("r", (RecipeStep("cle", {"include_approx_pairs": True}),)
               ).validate()


@pytest.mark.parametrize("stage", NOT_PORTED)
def test_unported_stage_raises_naming_it(stage):
    assert stage in jax_pipeline.list_stages()      # a JAX stage
    with pytest.raises(PipelineError, match=f"{stage}.*not ported yet"):
        repro_torch.quantize(ARCH, recipe=["fold_norm", stage], device="cpu")


def test_unported_recipe_and_missing_recipe_raise():
    with pytest.raises(PipelineError, match="dfq-int8.*not ported yet"):
        resolve_recipe("dfq-int8")
    with pytest.raises(PipelineError, match="needs a recipe"):
        repro_torch.quantize(ARCH, device="cpu")


def test_registry_dispatch_custom_stage():
    @register_stage("test_tag_stage", tag="default")
    def test_tag_stage(state, ctx, *, tag):
        state.note(tag=tag)
        return state

    try:
        qm = repro_torch.quantize(
            ARCH, recipe=[("test_tag_stage", {"tag": "hello"}), "pack"],
            device="cpu")
        assert qm.stage_record("test_tag_stage")["metrics"]["tag"] == "hello"
        assert "test_tag_stage" in list_stages()
        assert isinstance(qm.params["blocks"]["attn"]["wq"], QTensor)
        with pytest.raises(PipelineError, match="already registered"):
            register_stage("test_tag_stage")(test_tag_stage)
    finally:
        unregister_stage("test_tag_stage")
    assert "test_tag_stage" not in list_stages()


def test_quantize_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.quantize(ARCH, recipe="serve-w8a16-kv8")


# ------------------------------------------------------ parity with the JAX

@pytest.fixture(scope="module")
def hostile():
    jm, jp = hostile_jax_params("qwen2-0.5b")
    cfg = get_config(ARCH)
    return jp, from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict) and set(tree) != {"q", "scale", "mode"}:
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, QTensor):
        yield path, {"q": tree.q.numpy(), "scale": tree.scale.numpy(),
                     "mode": tree.mode}
    else:
        yield path, tree


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_quantize_matches_jax(hostile, recipe, per_channel):
    jp, tp = hostile
    opts = {"pack": {"per_channel": True}} if per_channel else None
    jq = repro.quantize(ARCH, params=jp, recipe=recipe, stage_options=opts)
    tq = repro_torch.quantize(ARCH, tp, recipe=recipe, stage_options=opts,
                              device="cpu")
    jl, tl = dict(_leaves(jax_to_numpy(jq.params))), dict(_leaves(tq.params))
    assert sorted(jl) == sorted(tl)
    n_q = 0
    for path, t in tl.items():
        j = jl[path]
        if isinstance(t, dict):
            n_q += 1
            assert t["mode"] == j["mode"] == recipe.split("-")[1]
            np.testing.assert_array_equal(t["q"], j["q"], err_msg=str(path))
            np.testing.assert_array_equal(t["scale"], j["scale"],
                                          err_msg=str(path))
        elif path == ("blocks", "attn", "bo"):
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    assert n_q == 7
    # K-major storage of every packed weight
    assert all(q.q.transpose(-1, -2).is_contiguous() for q in
               (tq.params["blocks"]["attn"]["wq"], tq.params["blocks"]["mlp"]["wd"]))
    # the same stage records, metrics and all
    assert [r["stage"] for r in tq.report] == [r["stage"] for r in jq.report]
    for rt, rj in zip(tq.report, jq.report):
        assert rt["options"] == rj["options"]
        mt, mj = dict(rt["metrics"]), dict(rj["metrics"])
        st, sj = mt.pop("sqnr_db", {}), mj.pop("sqnr_db", {})
        assert mt == mj, rt["stage"]
        assert sorted(st) == sorted(sj)
        for k in st:
            assert abs(st[k] - sj[k]) < 1e-4, k
    assert tq.kv_bits == jq.cfg.kv_cache_bits == 8
    sq = tq.site_sqnr_db()
    assert sorted(sq) == sorted(jq.site_sqnr_db())
    assert tq.serving_summary() == jq.serving_summary()


def test_quantized_model_serves(hostile):
    """A QuantizedModel from the port prefills and decodes with its
    recorded int8 KV cache."""
    _, tp = hostile
    qm = repro_torch.quantize(ARCH, tp, recipe="serve-w8a16-kv8",
                              device="cpu")
    cache = qm.init_cache(2, 16, device="cpu")
    assert cache["k"].dtype == torch.int8
    lg, cache = qm.prefill(torch.zeros((2, 4), dtype=torch.long), cache)
    lg, cache = qm.decode_step(lg.argmax(-1)[:, None], cache)
    assert lg.shape == (2, 256) and bool(torch.isfinite(lg).all())
    assert qm.apply(torch.zeros((1, 3), dtype=torch.long)).shape == (1, 3, 256)
