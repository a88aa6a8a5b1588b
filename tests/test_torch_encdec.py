"""The encoder-decoder family (whisper-tiny: LayerNorm, a stubbed audio
front end, cross attention) against the JAX package at smoke size on the
same weights (JAX's init carried across, LayerNorm gains and shifts and the
attention biases drawn random so that folding and absorbing them does real
work), and ``layers.layer_norm`` against the reference's.

Tolerances: float32 forwards within ``FWD_TOL`` (``_torch_port``) of the
output's scale (summation order only); frames drawn by ``prng.normal`` within 4 ulp of
``jax.random.normal`` (``test_torch_prng.py``), so where bits matter the
tests carry JAX's frames across. Quantized weights are bit-equal; a bias
that a rewrite computed by a sum (the LayerNorm shift folded through a
weight, the absorbed value bias, bias correction's ε·E[x]) within
``BIAS_TOL`` of its scale (``_torch_port.summed_biases``).
"""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro
from _torch_port import (
    assert_quantized_equal,
    close,
    get_leaf,
    jax_to_numpy,
    leaves,
    plan_repr,
    summed_biases,
)
from repro.configs import get_config as jax_get_config
from repro.core import DFQConfig as JaxDFQConfig
from repro.core import apply_dfq as jax_apply_dfq
from repro.core.tree import set_path as jax_set_path
from repro.models import build_model as jax_build_model
from repro.models.encdec import sinusoidal_positions as jax_sinusoidal
from repro.models.layers import layer_norm as jax_layer_norm

import torch

import repro_torch
from repro_torch import get_config
from repro_torch.core import DFQConfig, apply_dfq
from repro_torch.data import prng
from repro_torch.models import EncDecModel, build_model
from repro_torch.models.encdec import sinusoidal_positions
from repro_torch.models.layers import layer_norm
from repro_torch.pipeline import QuantizedModel
from repro_torch.pipeline.api import default_calibration
from repro_torch.weights import from_jax_numpy

WHISPER = "whisper-tiny"


def _jax_params(seed=0):
    jm = jax_build_model(jax_get_config(WHISPER, smoke=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(20 + seed)
    for stack in ("enc_blocks", "dec_blocks"):
        norms = ["attn_norm", "mlp_norm"] + (
            ["cross_norm"] if stack == "dec_blocks" else [])
        for n in norms:
            shape = np.asarray(jp[stack][n]["w"]).shape
            jp = jax_set_path(jp, (stack, n, "w"), jnp.asarray(
                np.exp(rng.randn(*shape) * 0.5).astype(np.float32)))
            jp = jax_set_path(jp, (stack, n, "b"), jnp.asarray(
                (rng.randn(*shape) * 0.3).astype(np.float32)))
        for a in ["attn"] + (["cross"] if stack == "dec_blocks" else []):
            for b in ("bq", "bk", "bv", "bo"):
                shape = np.asarray(jp[stack][a][b]).shape
                jp = jax_set_path(jp, (stack, a, b), jnp.asarray(
                    (rng.randn(*shape) * 0.3).astype(np.float32)))
    return jm, jp


@pytest.fixture(scope="module")
def pair():
    jm, jp = _jax_params()
    cfg = get_config(WHISPER, smoke=True)
    return jm, jp, build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                                    device="cpu")


def _frames(B=2, seed=0):
    cfg = get_config(WHISPER, smoke=True)
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (B, cfg.enc_seq, cfg.d_model)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """eps 1e-5, the population variance, statistics in float32; bf16
    within one bf16 ulp of the output's scale."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 48) * 3 + 1).astype(np.float32)
    w, b = rng.randn(48).astype(np.float32), rng.randn(48).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    yj = jax_layer_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                        jnp.asarray(b))
    yt = layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                    torch.from_numpy(b))
    assert yt.dtype == tdt
    close(yt, yj, tol=1e-6 if dtype == "float32" else 2.0 ** -7)


def test_sinusoidal_positions_match_jax():
    """Within 1e-5: the angles reach 1500 rad, where a float32 angle is
    only known to 1.2e-4, and the frameworks' pow differs in the last
    bits."""
    close(sinusoidal_positions(1500, 384), jax_sinusoidal(1500, 384),
          tol=1e-5)


def test_forward_loss_and_stats_match_jax(pair):
    """The encoder (bidirectional), the teacher-forced decoder with cross
    attention, the loss with frames, and the calibration stats (``enc_*``,
    ``dec_*``, ``cross_*``)."""
    jm, jp, tm, tp = pair
    toks = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(np.int32)
    fr = _frames()
    yj, (_, sj) = jm.apply(jp, jnp.asarray(toks), jnp.asarray(fr),
                           capture=True)
    yt, st = tm.apply(tp, torch.from_numpy(toks).long(),
                      torch.from_numpy(fr), capture=True)
    close(yt, yj)
    assert sorted(st) == sorted(sj)
    for k in sj:
        assert tuple(st[k].shape) == sj[k].shape, k
        close(st[k], sj[k], msg=k)
    # the zeros stub when no frames are given
    close(tm.apply(tp, torch.from_numpy(toks).long()),
           jm.apply(jp, jnp.asarray(toks))[0])
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1), "frames": fr}
    lj = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lt = tm.loss(tp, {"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(batch["labels"]).long(),
                      "frames": torch.from_numpy(fr)})
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)


def test_warm_cache_prefill_and_decode_match_jax(pair):
    """``warm_cache`` (the encoder pass and every layer's cross K/V), a
    9-token prefill and 6 decode steps: the cache leaves and each step's
    logits equal the reference's, and the last step the teacher-forced
    forward's (``test_models_smoke.py``'s check)."""
    jm, jp, tm, tp = pair
    B, T = 2, 15
    toks = np.random.RandomState(2).randint(0, 256, (B, T)).astype(np.int32)
    fr = _frames(seed=3)
    jc = jm.warm_cache(jp, jnp.asarray(fr),
                       jm.init_cache(B, 32, dtype=jnp.float32))
    tc = tm.warm_cache(tp, torch.from_numpy(fr),
                       tm.init_cache(B, 32, device="cpu",
                                     dtype=torch.float32))
    assert sorted(tc) == sorted(jc)
    for k in ("ck", "cv"):
        close(tc[k], jc[k], msg=k)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :9]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :9]).long(), tc)
    close(tl, jl)
    for t in range(9, T):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                tc)
        close(tl, jl, msg=f"step {t}")
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    assert int(tc["pos"]) == int(jc["pos"]) == T
    full = tm.apply(tp, torch.from_numpy(toks).long(), torch.from_numpy(fr))
    close(tl, full[:, -1].numpy(), tol=1e-4)


def test_cache_is_fp_whole_batch_and_serving_refused(pair):
    _, _, tm, tp = pair
    c = build_model(dataclasses.replace(tm.cfg, kv_cache_bits=8)).init_cache(
        2, 8, device="cpu")
    assert c["k"].dtype == torch.float32 and c["ck"].shape[2] == 16
    with pytest.raises(ValueError, match="per-slot"):
        tm.init_cache(2, 8, device="cpu", per_slot=True)
    with pytest.raises(ValueError, match="attention-family"):
        repro_torch.ServingEngine(tm, tp, tm.cfg, device="cpu")
    with pytest.raises(repro_torch.ServeConfigError,
                       match="'audio' archs via repro_torch.pipeline.cli"):
        repro_torch.serve(repro_torch.ServeConfig(arch=WHISPER, smoke=True,
                                                  device="cpu"))


def test_dfq_plan_equals_jax(pair):
    """Op for op, site for site: the LayerNorm folds with their shifts, the
    V/O and Q/K pairs and V-bias absorption of the encoder's, decoder's and
    cross attention, the approximate GELU pairs."""
    jm, _, tm, _ = pair
    assert plan_repr(tm.dfq_plan()) == plan_repr(jm.dfq_plan())
    assert len(tm.dfq_plan().sites) == 16


def _rel_change(tm, tp, eq, toks, fr):
    y0, y1 = tm.apply(tp, toks, fr), tm.apply(eq, toks, fr)
    return float((y1 - y0).abs().max()) / (float(y0.abs().max()) + 1e-6)


def test_apply_dfq_keeps_the_function(pair):
    """The rewrites (the approximate GELU pairs skipped, as by default)
    equal the reference's leaf for leaf. They keep the logits within 5e-3
    of their scale where ``cross_norm`` is the identity (the reference's
    init); the reference's plan folds ``cross_norm`` into the cross
    attention's wk / wv too, which read the encoder output, so a
    non-identity ``cross_norm`` changes the function — in both packages
    alike (a defect of the reference the port keeps for parity)."""
    jm, jp, tm, tp = pair
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 8)))
    fr = torch.from_numpy(_frames())
    eq = apply_dfq(tp, tm.dfq_plan(), DFQConfig())
    jeq = jax_to_numpy(jax_apply_dfq(jp, jm.dfq_plan(), JaxDFQConfig()))
    for path, t in leaves(eq):
        close(t, get_leaf(jeq, path), tol=1e-6, msg=str(path))
    assert _rel_change(tm, tp, eq, toks, fr) > 0.1
    ident = {**tp, "dec_blocks": {**tp["dec_blocks"], "cross_norm": {
        "w": torch.ones_like(tp["dec_blocks"]["cross_norm"]["w"]),
        "b": torch.zeros_like(tp["dec_blocks"]["cross_norm"]["b"])}}}
    eq = apply_dfq(ident, tm.dfq_plan(), DFQConfig())
    assert _rel_change(tm, ident, eq, toks, fr) < 5e-3


def test_default_calibration_draws_the_reference_frames(pair, monkeypatch):
    """The encoder-decoder's calibration hook feeds ``prng.normal`` frames
    under ``PRNGKey(seed)``: within 4 ulp of the reference's draw."""
    _, _, tm, tp = pair
    seen = {}

    def spy(params, toks, frames=None):
        seen["frames"] = frames
        return {}

    monkeypatch.setattr(tm, "calibration_stats", spy)
    default_calibration(tm, tm.cfg, seed=1, batch=2, seq=8)(tp)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (2, 16, 64)))
    got = seen["frames"].numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))


@pytest.mark.parametrize("recipe", ["dfq-int8", "serve-w8a16"])
def test_quantize_matches_jax(pair, recipe, monkeypatch):
    """``repro_torch.quantize`` against ``repro.quantize`` leaf by leaf, the
    calibration frames carried across from JAX (``prng.normal`` differs in
    the last bits): dfq-int8 corrects the ten sites with a statistic."""
    jm, jp, tm, tp = pair
    jq = repro.quantize(jm, params=jp, recipe=recipe)
    monkeypatch.setattr(prng, "normal", lambda key, shape: np.array(
        jax.random.normal(jax.random.PRNGKey(1), shape)))
    tq = repro_torch.quantize(tm, tp, recipe=recipe, device="cpu")
    names = []
    if recipe == "dfq-int8":
        names = tq.stage_record("bias_correct")["metrics"]["sites_corrected"]
        assert len(names) == 10
    assert_quantized_equal(tq, jq, summed_biases(tm.dfq_plan(), names))


def test_artifact_loads_in_both_packages(pair, tmp_path):
    """serve-w8a8 artifacts across the packages: config and leaves equal,
    the loaded model's warmed prefill + decode logits the saver's."""
    jm, jp, tm, tp = pair
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jq = repro.quantize(jm, params=jp, recipe="serve-w8a8")
    jq.save(jdir)
    qm = QuantizedModel.load(jdir, device="cpu")
    assert qm.cfg == get_config(WHISPER, smoke=True)
    assert isinstance(qm.model, EncDecModel)
    assert_quantized_equal(qm, jq)
    tq = repro_torch.quantize(tm, tp, recipe="serve-w8a8", device="cpu")
    tq.save(tdir)
    back = repro.QuantizedModel.load(tdir)
    for f in dataclasses.fields(tq.cfg):
        assert getattr(back.cfg, f.name) == getattr(tq.cfg, f.name), f.name
    assert_quantized_equal(tq, back)
    toks = np.random.RandomState(5).randint(0, 256, (2, 10)).astype(np.int32)
    fr = _frames(seed=5)
    jc = back.model.warm_cache(back.params, jnp.asarray(fr),
                               back.model.init_cache(2, 16, dtype=jnp.float32))
    tc = qm.model.warm_cache(qm.params, torch.from_numpy(fr),
                             qm.init_cache(2, 16, device="cpu",
                                           dtype=torch.float32))
    jl, jc = back.model.prefill(back.params, jnp.asarray(toks[:, :6]), jc)
    tl, tc = qm.prefill(torch.from_numpy(toks[:, :6]).long(), tc)
    close(tl, jl, tol=1e-4)
    for t in range(6, 10):
        jl, jc = back.model.decode_step(back.params,
                                        jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = qm.decode_step(torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        close(tl, jl, tol=1e-4, msg=f"step {t}")


def test_full_width_config_builds_as_the_reference():
    """Every config field the reference's (full width and smoke), the
    parameter count its and in the public range, the plan its, and the
    input specs' frames."""
    from repro_torch.models import SHAPE_BY_NAME, input_specs

    for smoke in (False, True):
        cfg = get_config(WHISPER, smoke=smoke)
        jcfg = jax_get_config(WHISPER, smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.param_count() == jcfg.param_count()
    cfg = get_config(WHISPER)
    assert cfg.is_encdec and 25e6 <= cfg.param_count() <= 80e6
    assert plan_repr(build_model(cfg).dfq_plan()) == plan_repr(
        jax_build_model(jax_get_config(WHISPER)).dfq_plan())
    specs = input_specs(cfg, SHAPE_BY_NAME["prefill_32k"])
    assert tuple(specs["frames"].shape) == (32, 1500, 384)
    assert specs["frames"].dtype == torch.bfloat16


def test_init_draws_the_reference_layout():
    tp = build_model(get_config(WHISPER, smoke=True)).init(0, device="cpu")
    jp = jax_build_model(jax_get_config(WHISPER, smoke=True)).init(
        jax.random.PRNGKey(0))
    tl, jl = dict(leaves(tp)), dict(leaves(jax_to_numpy(jp)))
    assert sorted(tl) == sorted(jl)
    for k in tl:
        assert tuple(tl[k].shape) == jl[k].shape, k


def test_cli_quantizes_whisper(tmp_path):
    from repro_torch.pipeline.cli import main

    d = str(tmp_path / "w")
    assert main(["--arch", WHISPER, "--smoke", "--recipe", "dfq-int8",
                 "--device", "cpu", "--save", d]) == 0
    assert os.path.exists(os.path.join(d, "quantized_model.json"))
    assert repro.QuantizedModel.load(d).cfg.is_encdec
