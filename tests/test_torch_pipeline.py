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

The paper's Fig. 4 recipes (``dfq-int8``, ``naive-int8``, ``cle-only``)
and the bias-corrected w8a8 deployment run on the same weights with the
same (JAX) calibration tokens on both sides, each side's forward computing
its own E[x]. Every weight leaf (fake-quantized or packed) must be
bit-equal: quantization reads the weights only. A corrected bias ``b − ε·
E[x]`` is held to ``|δ| @ |ε| + 2·D·2⁻²⁴·(|E[x]| @ |ε|)`` plus one ulp of
|b|, δ being the measured gap between the two sides' E[x] (itself within
``STAT_TOL`` of ``test_torch_bias_correction.py``) — and ``bo`` to that
plus today's 2e-6 of its absorption. ``act_ranges``' ranges are held to
``RANGE_TOL`` of their magnitude (min, max and a population std of means
that differ by δ; measured max 2.2e-7 relative).

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
#: the bias-corrected int8 deployment chip_smoke.py serves
BC_DEPLOY = ["fold_norm", "cle", "bias_absorb", "bias_correct",
             ("pack", {"mode": "w8a8"}), ("kv_cache", {"bits": 8})]
STAT_TOL = 2.0 ** -16
RANGE_TOL = 1e-5


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
    """Every built-in of the JAX package — the four tensor-parallel ``-tp``
    deployments among them — step for step."""
    assert list_recipes() == jax_pipeline.list_recipes()
    assert {"serve-w8a16-kv8-tp", "serve-w8a16-tp", "serve-w8a8-kv8-tp",
            "serve-w8a8-tp"} <= set(list_recipes())
    for name in list_recipes():
        r = resolve_recipe(name)
        r.validate()
        jr = jax_pipeline.resolve_recipe(name)
        assert [(s.stage, dict(s.options)) for s in r.steps] == \
               [(s.stage, dict(s.options)) for s in jr.steps]


def test_kv_cache_refuses_the_unported_fp_cache():
    """bits=16 is the JAX package's fp KV cache, which the port now serves:
    the stage records it as it records 8, and refuses any other width, as
    the JAX stage does."""
    with pytest.raises(PipelineError, match="bits must be 8 or 16"):
        repro_torch.quantize(ARCH, recipe=[("kv_cache", {"bits": 4})],
                             device="cpu")
    for bits in (16, 8):
        qm = repro_torch.quantize(ARCH, recipe=[("kv_cache", {"bits": bits})],
                                  device="cpu")
        assert qm.kv_bits == qm.cfg.kv_cache_bits == bits


def test_config_and_cle_stage_take_only_options_the_port_reads():
    """``DFQConfig`` holds the JAX config's fields in its order, with the
    JAX defaults and quantizer specs — high-bias absorption's n-sigma and
    the plain-GELU pairs included, since ``run_plan_ops`` reads both now —
    and the cle stage takes the approximate-pair option as JAX's does. A
    field the JAX config lacks still raises."""
    from repro.core import DFQConfig as JaxDFQConfig

    from repro_torch.core import DFQConfig

    names = [f.name for f in dataclasses.fields(DFQConfig)]
    assert names == [f.name for f in dataclasses.fields(JaxDFQConfig)]
    assert "n_sigma_absorb" in names and "cle_include_approx_pairs" in names
    jax_cfg = JaxDFQConfig()
    for name in names:
        assert getattr(DFQConfig(), name) == getattr(jax_cfg, name), name
    cfg = DFQConfig(weight_bits=4, weight_symmetric=True, per_channel=True,
                    act_symmetric=True)
    jcfg = JaxDFQConfig(weight_bits=4, weight_symmetric=True, per_channel=True,
                        act_symmetric=True)
    for spec in ("weight_spec", "act_spec"):
        mine, theirs = getattr(cfg, spec), getattr(jcfg, spec)
        assert (mine.bits, mine.symmetric, mine.per_channel_axis) == (
            theirs.bits, theirs.symmetric, theirs.per_channel_axis)
    with pytest.raises(TypeError, match="n_sigma"):
        DFQConfig(n_sigma=4)
    Recipe("r", (RecipeStep("cle", {"include_approx_pairs": True}),)
           ).validate()
    with pytest.raises(RecipeError, match="include_approx"):
        Recipe("r", (RecipeStep("cle", {"include_approx": True}),)).validate()


def test_unported_recipe_and_missing_recipe_raise():
    """Every stage of the JAX pipeline is the port's; an unknown recipe
    raises with a suggestion; with no recipe, ``quantize`` runs the JAX
    default, dfq-int8."""
    assert list_stages() == jax_pipeline.list_stages()
    with pytest.raises(RecipeError, match="serve-w8a8-tp"):
        resolve_recipe("serve-w8a8-tq")
    qm = repro_torch.quantize(ARCH, device="cpu")
    assert qm.recipe.name == "dfq-int8"
    assert [r["stage"] for r in qm.report] == [
        "fold_norm", "cle", "bias_absorb", "bias_correct", "weight_quant"]


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


# ------------------------------------------- the paper's flow against JAX

@pytest.fixture(scope="module")
def calib(hostile):
    """(JAX model, port model, JAX calibration tokens as numpy)."""
    from repro.configs import get_config as jax_get_config
    from repro.data import calibration_tokens as jax_calibration_tokens
    from repro.models import build_model as jax_build_model

    jm = jax_build_model(jax_get_config(ARCH))
    tm = repro_torch.build_model(get_config(ARCH))
    toks = np.array(jax_calibration_tokens(1, 2, 32, 256))
    return jm, tm, toks


def _recording(fn, into):
    def calibrate(params):
        into.update(fn(params))
        return into
    return calibrate


def _quantize_both(hostile, calib, recipe, **kw):
    """Both packages on the same weights and tokens; returns the two
    QuantizedModels and the E[x] each side's bias correction read."""
    import jax.numpy as jnp

    jp, tp = hostile
    jm, tm, toks = calib
    jmeans, tmeans = {}, {}
    jq = repro.quantize(ARCH, params=jp, recipe=recipe, calibration=_recording(
        lambda p: jm.calibration_stats(p, jnp.asarray(toks)), jmeans), **kw)
    tq = repro_torch.quantize(ARCH, tp, recipe=recipe, device="cpu",
                              calibration=_recording(
        lambda p: tm.calibration_stats(p, torch.from_numpy(toks).long()),
        tmeans), **kw)
    return jq, tq, jmeans, tmeans


def _correction_bound(jq, recipe, jmeans, tmeans, path, cfg):
    """|δ| @ |ε| + 2·D·2⁻²⁴·(|E[x]| @ |ε|) + one ulp of |b|, over the site
    whose bias is ``path`` (ε of the equalized weights, with the spec the
    recipe's bias_correct used)."""
    from repro.core.bias_correction import weight_quant_error
    from repro.core.tree import get_path as jget

    steps = [s.stage for s in resolve_recipe(recipe).steps]
    pre = steps[:steps.index("bias_correct")]
    eq = repro.quantize(ARCH, params=jq._hostile_params, recipe=pre,
                        calibration=None).params
    site = next(s for s in jq.model.dfq_plan().sites if s.b == path)
    eps = np.abs(np.asarray(weight_quant_error(jget(eq, site.w),
                                               cfg.weight_spec)))
    e_j = np.asarray(jmeans[site.stat_key], np.float64)
    delta = np.abs(tmeans[site.stat_key].numpy() - e_j)
    D = eps.shape[-2]
    return (np.einsum("...i,...io->...o", delta, eps)
            + 2 * D * 2.0 ** -24 * np.einsum("...i,...io->...o", np.abs(e_j),
                                             eps)) * (1 + 2.0 ** -20)


@pytest.mark.parametrize("recipe", ["dfq-int8", "naive-int8", "cle-only",
                                    "bc-w8a8-kv8"])
def test_fig4_recipes_match_jax(hostile, calib, recipe):
    """Weights bit-equal; each corrected bias within its bound; E[x] within
    STAT_TOL; the stage records equal (SQNR within 1e-4 dB)."""
    from repro.core.dfq import DFQConfig as JaxDFQConfig
    from repro.pipeline.api import _fold_weight_spec_overrides

    spec = BC_DEPLOY if recipe == "bc-w8a8-kv8" else recipe
    jq, tq, jmeans, tmeans = _quantize_both(hostile, calib, spec)
    jq._hostile_params = hostile[0]
    jcfg = _fold_weight_spec_overrides(repro.pipeline.resolve_recipe(spec),
                                       JaxDFQConfig())
    corrected = "bias_correct" in [s.stage for s in tq.recipe.steps]
    assert bool(jmeans) == bool(tmeans) == corrected
    for k, e in jmeans.items():
        e = np.asarray(e)
        assert np.abs(tmeans[k].numpy() - e).max() <= STAT_TOL * np.abs(e).max()
    jl, tl = dict(_leaves(jax_to_numpy(jq.params))), dict(_leaves(tq.params))
    assert sorted(jl) == sorted(tl)
    site_biases = {s.b for s in tq.model.dfq_plan().sites}
    for path, t in tl.items():
        j = jl[path]
        if isinstance(t, dict):
            np.testing.assert_array_equal(t["q"], j["q"], err_msg=str(path))
            np.testing.assert_array_equal(t["scale"], j["scale"])
            assert t["mode"] == j["mode"]
        elif corrected and path in site_biases:
            bound = _correction_bound(jq, spec, jmeans, tmeans, path, jcfg)
            bound = bound + np.spacing(np.maximum(np.abs(j), np.abs(t.numpy())))
            if path == ("blocks", "attn", "bo"):
                bound = bound + 2e-6
            diff = np.abs(t.numpy() - j)
            assert (diff <= bound).all(), (path, diff.max())
        elif path == ("blocks", "attn", "bo") and recipe != "naive-int8" \
                and recipe != "cle-only":
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    if corrected:       # the MLP biases the seeded model lacks are created
        assert {"bg", "bu"} <= set(tq.params["blocks"]["mlp"])
    assert [r["stage"] for r in tq.report] == [r["stage"] for r in jq.report]
    for rt, rj in zip(tq.report, jq.report):
        assert rt["options"] == rj["options"]
        mt, mj = dict(rt["metrics"]), dict(rj["metrics"])
        st, sj = mt.pop("sqnr_db", {}), mj.pop("sqnr_db", {})
        for k in ("sqnr_min_db", "sqnr_mean_db"):
            if k in mj:
                assert abs(mt.pop(k) - mj.pop(k)) < 1e-4, k
        assert mt == mj, rt["stage"]
        assert sorted(st) == sorted(sj)
        assert all(abs(st[k] - sj[k]) < 1e-4 for k in st)
    assert sorted(tq.site_sqnr_db()) == sorted(jq.site_sqnr_db())
    assert tq.kv_bits == (8 if recipe == "bc-w8a8-kv8" else 16)


def test_weight_quant_override_reaches_bias_correct_epsilon(calib):
    """A per-stage bits override also drives the ε = fq(W) − W of
    bias_correct — one quant spec for the whole recipe: the staged run is
    bit-equal to the hand-rolled apply_dfq → bias_correct → quantize_weights
    chain at 4 bits, and its biases differ from the 8-bit ε's."""
    from repro_torch.core import (
        DFQConfig,
        apply_dfq,
        bias_correct,
        quantize_weights,
    )

    import jax

    jm, tm, toks = calib
    # the seeded init, as the JAX test: apply_dfq interleaves the plan's
    # ops, which on random biases rounds apart from the staged schedule
    tp = from_jax_numpy(jax_to_numpy(jm.init(jax.random.PRNGKey(0))),
                        tm.cfg, device="cpu")
    calibrate = lambda p: tm.calibration_stats(p, torch.from_numpy(toks).long())
    plan = tm.dfq_plan()
    cfg4 = DFQConfig(weight_bits=4)
    eq = apply_dfq(tp, plan, cfg4)
    ref = quantize_weights(bias_correct(eq, plan, cfg4, calibrate(eq)), plan,
                           cfg4)
    qm = repro_torch.quantize(tm, tp, recipe="dfq-int8", calibration=calibrate,
                              stage_options={"weight_quant": {"bits": 4}},
                              device="cpu")
    assert qm.stage_record("weight_quant")["metrics"]["bits"] == 4
    for (p, a), (_, b) in zip(_leaves(ref), _leaves(qm.params)):
        assert torch.equal(a, b), p
    q8 = repro_torch.quantize(tm, tp, recipe="dfq-int8", calibration=calibrate,
                              device="cpu")
    assert not torch.equal(q8.params["blocks"]["mlp"]["bg"],
                           qm.params["blocks"]["mlp"]["bg"])


def test_dfq_quantize_and_legacy_chain(hostile, calib):
    """``core.dfq_quantize`` (through ``run_legacy_dfq``) is the dfq-int8
    recipe, bit for bit; its switches drop the stages they name, as the
    JAX wrapper's do (the weights then bit-equal to JAX's)."""
    from repro.core import DFQConfig as JaxDFQConfig
    from repro.core import dfq_quantize as jax_dfq_quantize

    from repro_torch.core import DFQConfig, dfq_quantize

    jp, tp = hostile
    jm, tm, toks = calib
    calibrate = lambda p: tm.calibration_stats(p, torch.from_numpy(toks).long())
    plan = tm.dfq_plan()
    legacy = dfq_quantize(tp, plan, DFQConfig(), input_means_fn=calibrate)
    qm = repro_torch.quantize(tm, tp, recipe="dfq-int8", calibration=calibrate,
                              device="cpu")
    for (p, a), (_, b) in zip(_leaves(legacy), _leaves(qm.params)):
        assert torch.equal(a, b), p
    for kw, fn in (({"bias_correct": "none"}, calibrate),
                   ({"cle": False, "bias_absorb": False}, None)):
        got = dfq_quantize(tp, plan, DFQConfig(**kw), input_means_fn=fn)
        want = jax_to_numpy(jax_dfq_quantize(
            jp, jm.dfq_plan(), JaxDFQConfig(**kw), input_means_fn=None))
        assert "bg" not in got["blocks"]["mlp"]      # no correction ran
        for site in plan.sites:
            np.testing.assert_array_equal(
                got["blocks"][site.w[1]][site.w[2]].numpy(),
                want["blocks"][site.w[1]][site.w[2]], err_msg=f"{kw} {site.name}")


def test_act_ranges_match_jax(hostile, calib):
    """The ranges (β ± 6γ from the means, γ their population std) and their
    QParams against the JAX stage's, within RANGE_TOL of the range's
    magnitude; every range non-empty, every scale positive."""
    jq, tq, _, _ = _quantize_both(hostile, calib, ["fold_norm", "cle",
                                                    "act_ranges"])
    rt = tq.stage_record("act_ranges")["metrics"]
    rj = jq.stage_record("act_ranges")["metrics"]
    assert rt["keys"] == rj["keys"] == ["attn_in", "down_in", "final_h",
                                        "mlp_in", "o_in"]
    assert rt["n_sigma"] == rj["n_sigma"] == 6.0
    for k, (lo, hi) in rj["ranges"].items():
        tlo, thi = rt["ranges"][k]
        mag = max(abs(lo), abs(hi))
        assert abs(tlo - lo) <= RANGE_TOL * mag and abs(thi - hi) <= RANGE_TOL * mag
        assert tlo < thi
        qp, jqp = tq.act_qparams[k], jq.act_qparams[k]
        assert float(qp.scale) > 0
        np.testing.assert_allclose(float(qp.scale), float(jqp.scale),
                                   rtol=2 * RANGE_TOL)
        assert abs(float(qp.zero_point) - float(jqp.zero_point)) <= 1
    assert set(tq.act_qparams) == set(rt["ranges"])


def test_bias_correct_stage_methods_and_skips(hostile):
    """method "none" and a missing calibration hook skip with a note; an
    unknown method, and "analytic" on a model without
    ``analytic_input_stats``, raise the JAX package's errors."""
    _, tp = hostile
    qm = repro_torch.quantize(ARCH, tp, recipe=[("bias_correct",
                                                 {"method": "none"})],
                              device="cpu")
    assert qm.report[0]["metrics"] == {"skipped": "method='none'"}
    qm = repro_torch.quantize(ARCH, tp, recipe=["bias_correct"],
                              calibration=None, device="cpu")
    assert qm.report[0]["metrics"] == {"skipped": "no calibration hook available"}
    assert "bg" not in qm.params["blocks"]["mlp"]
    with pytest.raises(PipelineError, match="unknown method 'exact'"):
        repro_torch.quantize(ARCH, tp, recipe=[("bias_correct",
                                                {"method": "exact"})],
                             device="cpu")
    with pytest.raises(PipelineError, match="analytic_input_stats"):
        repro_torch.quantize(ARCH, tp, recipe=[("bias_correct",
                                                {"method": "analytic"})],
                             device="cpu")
    with pytest.raises(PipelineError, match="calibration must be"):
        repro_torch.quantize(ARCH, tp, recipe="dfq-int8", calibration="data",
                             device="cpu")


def test_hostile_model_gate():
    """``test_dfq_integration.py``'s central claim on the port: per-tensor
    INT8 collapses on a hostile-ranged model (JAX init through
    ``hostile_rescale``, carried across) and dfq-int8 — calibrated on the
    port's own synthetic tokens — recovers: logits SQNR above naive-int8's
    by 10 dB, greedy agreement with fp above 0.9."""
    import jax

    from repro.core.adversarial import hostile_rescale
    from repro.models import build_model as jax_build_model
    from repro.configs import get_config as jax_get_config

    from repro_torch.core import DFQConfig, dfq_quantize, quantize_weights, sqnr_db
    from repro_torch.data import calibration_tokens

    jm = jax_build_model(jax_get_config(ARCH))
    jp = hostile_rescale(jm.init(jax.random.PRNGKey(0)), jm.dfq_plan(),
                         decades=1.2)
    cfg = get_config(ARCH)
    tm = repro_torch.build_model(cfg)
    params = from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")
    plan = tm.dfq_plan()
    toks = calibration_tokens(0, 2, 16, cfg.vocab_size, device="cpu")
    y_fp = tm.apply(params, toks)
    naive = quantize_weights(params, plan, DFQConfig(cle=False,
                                                     bias_absorb=False))
    q = dfq_quantize(params, plan, DFQConfig(), input_means_fn=lambda p:
                     tm.calibration_stats(p, calibration_tokens(1, 2, 32, 256,
                                                       device="cpu")))
    snr_naive = float(sqnr_db(y_fp, tm.apply(naive, toks)))
    y_dfq = tm.apply(q, toks)
    snr_dfq = float(sqnr_db(y_fp, y_dfq))
    assert snr_dfq > snr_naive + 10.0, (snr_naive, snr_dfq)
    assert float((y_fp.argmax(-1) == y_dfq.argmax(-1)).float().mean()) > 0.9


def test_report_carries_per_site_weight_sqnr(hostile):
    """site_sqnr_db reads weight_quant's record (fake-quant recipes) as it
    reads pack's."""
    _, tp = hostile
    qm = repro_torch.quantize(ARCH, tp, recipe="naive-int8", calibration=None,
                              device="cpu")
    snr = qm.site_sqnr_db()
    assert set(snr) == {s.name for s in qm.model.dfq_plan().sites}
    assert all(np.isfinite(v) for v in snr.values())
    assert qm.stage_record("weight_quant")["metrics"]["sqnr_min_db"] == min(
        snr.values())
