"""The SSM families — mamba2-2.7b (Mamba2's chunked SSD) and zamba2-2.7b
(Mamba2 layers with two shared attention blocks) — against the JAX package,
at smoke size on the same weights (JAX's init carried across, the norm
gains drawn log-normal so that folding them does real work).

Tolerances: float32 forwards agree within ``FWD_TOL`` (``_torch_port``)
of the output's scale (summation order only: XLA's and PyTorch's einsums
and cumsums add in other orders; measured below 1e-6); the stats within
``STAT_TOL``.
Quantized weights are bit-equal, the packed payloads and scales too; a
bias that bias correction moved agrees within ``BIAS_TOL`` (it reads E[x]
from each framework's forward; ``_torch_port.summed_biases``).
"""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro
from _torch_port import (
    FWD_TOL,
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
from repro.models import mamba as jax_mamba

import torch

import repro_torch
from repro_torch import get_config
from repro_torch.core import DFQConfig, apply_dfq
from repro_torch.models import build_model
from repro_torch.models import mamba
from repro_torch.models.lm import _layer
from repro_torch.pipeline import QuantizedModel
from repro_torch.weights import from_jax_numpy

MAMBA, ZAMBA = "mamba2-2.7b", "zamba2-2.7b"
STAT_TOL = 1e-5


def _jax_params(arch, seed=0):
    """(JAX model, params): the smoke init, every norm gain log-normal."""
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(10 + seed)
    paths = [("blocks", "norm", "w")]
    if "shared_blocks" in jp:
        paths += [("shared_blocks", n, "w") for n in ("attn_norm", "mlp_norm")]
    for path in paths:
        shape = np.asarray(jp[path[0]][path[1]]["w"]).shape
        jp = jax_set_path(jp, path, jnp.asarray(
            np.exp(rng.randn(*shape) * 0.5).astype(np.float32)))
    return jm, jp


def _pair(arch):
    jm, jp = _jax_params(arch)
    cfg = get_config(arch, smoke=True)
    return jm, jp, build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                                    device="cpu")


@pytest.fixture(scope="module")
def pairs():
    return {MAMBA: _pair(MAMBA), ZAMBA: _pair(ZAMBA)}


def _ssd_inputs(T, seed=0, b=2, H=8, P=4, G=2, S=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, T, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, T, H))).astype(np.float32)
    A = -np.exp(rng.randn(H)).astype(np.float32)
    B = rng.randn(b, T, G, S).astype(np.float32)
    C = rng.randn(b, T, G, S).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("T,chunk", [(6, 8), (16, 8), (24, 8)],
                         ids=["below", "at", "above"])
def test_ssd_chunked_matches_jax(T, chunk):
    """One chunk shorter than ``ssm_chunk`` (Q = T), exactly two chunks,
    three chunks: y and the final state."""
    args = _ssd_inputs(T)
    yj, sj = jax_mamba.ssd_chunked(*map(jnp.asarray, args), chunk)
    yt, st = mamba.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert st.dtype == torch.float32
    close(yt, yj)
    close(st, sj)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    """The taps summed in order from tap 0, as the reference: bit-equal."""
    rng = np.random.RandomState(1)
    xbc = rng.randn(2, 5, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32) if with_state else None
    oj, nj = jax_mamba._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
    ot, nt = mamba._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    close(ot, oj, tol=1e-6)


def test_softplus_is_logaddexp_above_the_threshold():
    """``F.softplus`` turns into the identity above 20; the reference's is
    log(1 + eˣ) everywhere."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.5, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(mamba._softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


@pytest.mark.parametrize("T", [5, 16, 21])
def test_mamba_block_prefill_matches_the_decode_recurrence(pairs, T):
    """The chunked prefill (T padded to a multiple of the smoke chunk, 8,
    with dt = 0) against T steps of the O(1) recurrence from a zero state:
    the outputs and the final SSM and conv states; and the block against
    the reference's."""
    jm, jp, tm, tp = pairs[MAMBA]
    cfg = tm.cfg
    lp = _layer(tp["blocks"]["mixer"], 0)
    x = torch.from_numpy(np.random.RandomState(T).randn(2, T, 64)
                         .astype(np.float32))
    din, H, G, S, _, d_conv = mamba.ssm_dims(cfg)

    def fresh():
        return {"ssm": torch.zeros((2, H, cfg.ssm_head_dim, S)),
                "conv": torch.zeros((2, cfg.ssm_conv_width - 1, d_conv))}

    y, st = mamba.mamba_block(lp, x, cfg, state=fresh())
    state, ys = fresh(), []
    for t in range(T):
        yt, state = mamba.mamba_block(lp, x[:, t:t + 1], cfg, state=state)
        ys.append(yt)
    close(torch.cat(ys, 1), y.numpy(), tol=1e-5)
    close(state["ssm"], st["ssm"].numpy(), tol=1e-5)
    # the conv state holds in_proj outputs: one GEMM of T rows against T
    # GEMMs of one row, which block their sums differently
    close(state["conv"], st["conv"].numpy(), tol=1e-6)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["mixer"])
    yj, sj, _ = jax_mamba.mamba_block(jl, jnp.asarray(x.numpy()), jm.cfg,
                                      state=jax.tree.map(jnp.asarray, {
                                          k: v.numpy()
                                          for k, v in fresh().items()}))
    close(y, yj)
    close(st["ssm"], sj["ssm"])


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_forward_loss_and_stats_match_jax(pairs, arch):
    """The eval forward's logits, the loss, and the calibration stats (the
    hybrid's nested ``mamba`` / ``shared_<seg>`` keys included)."""
    jm, jp, tm, tp = pairs[arch]
    toks = np.random.RandomState(2).randint(0, 256, (2, 16)).astype(np.int32)
    yj, (_, sj) = jm.apply(jp, jnp.asarray(toks), capture=True)
    yt, st = tm.apply(tp, torch.from_numpy(toks).long(), capture=True)
    close(yt, yj)

    def flat(tree, pre=()):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, pre + (k,)))
            return out
        return {pre: tree}

    fj, ft = flat(sj), flat(st)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert tuple(ft[k].shape) == np.asarray(fj[k]).shape, k
        close(ft[k], fj[k], tol=STAT_TOL, msg=str(k))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    lj = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lt = tm.loss(tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    assert abs(float(lt) - np.log(256)) < 2.0


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_prefill_and_decode_match_jax_and_the_forward(pairs, arch):
    """An 11-token prefill and 9 decode steps over the whole-batch cache
    (float32 SSM states, the hybrid's fp attention cache of one entry a
    segment): every step's logits equal the reference's, and the last the
    teacher-forced forward's (``test_models_smoke.py``'s check)."""
    jm, jp, tm, tp = pairs[arch]
    B, T = 2, 20
    toks = np.random.RandomState(3).randint(0, 256, (B, T)).astype(np.int32)
    jc = jm.init_cache(B, 32, dtype=jnp.float32)
    tc = tm.init_cache(B, 32, device="cpu", dtype=torch.float32)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
    assert tc["ssm"].dtype == torch.float32
    if arch == ZAMBA:
        assert tc["k"].shape[0] == tm.cfg.n_layers // tm.cfg.hybrid_attn_every
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :11]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :11]).long(), tc)
    close(tl, jl)
    decode = jax.jit(jm.decode_step)
    for t in range(11, T):
        jl, jc = decode(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                tc)
        close(tl, jl, msg=f"step {t}")
    close(tc["ssm"], jc["ssm"], tol=1e-5)
    assert int(tc["pos"]) == T
    full = tm.apply(tp, torch.from_numpy(toks).long())
    close(tl, full[:, -1].numpy(), tol=1e-4)


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_per_slot_cache_and_serving_are_refused(pairs, arch):
    """The reference's refusals: a per-slot cache, the serving engine and
    the launcher (which names the port's quantize CLI)."""
    _, _, tm, tp = pairs[arch]
    with pytest.raises(ValueError, match="per-slot caches are only supported"):
        tm.init_cache(2, 16, device="cpu", per_slot=True)
    with pytest.raises(ValueError, match="attention-family"):
        repro_torch.ServingEngine(tm, tp, tm.cfg, device="cpu")
    with pytest.raises(repro_torch.ServeConfigError,
                       match="repro_torch.pipeline.cli") as ei:
        repro_torch.serve(repro_torch.ServeConfig(arch=arch, smoke=True,
                                                  device="cpu"))
    assert "attention-family decoder-only models" in str(ei.value)


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_dfq_plan_equals_jax(pairs, arch):
    """Op for op and site for site: the mixers' norm fold and in/out
    projections, and the hybrid's attention ops on ``shared_blocks``."""
    jm, _, tm, _ = pairs[arch]
    assert plan_repr(tm.dfq_plan()) == plan_repr(jm.dfq_plan())
    names = [s.name for s in tm.dfq_plan().sites]
    assert names[:2] == ["ssm_in_proj", "ssm_out_proj"]
    assert len(names) == (2 if arch == MAMBA else 9)


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_apply_dfq_keeps_the_function(pairs, arch):
    """``test_dfq_integration.py``'s check on the port: the rewrites leave
    the float32 logits within 5e-3 of their scale, and the rewritten
    leaves equal the reference's."""
    jm, jp, tm, tp = pairs[arch]
    toks = np.random.RandomState(0).randint(0, 256, (2, 16))
    y0 = tm.apply(tp, torch.from_numpy(toks))
    eq = apply_dfq(tp, tm.dfq_plan(), DFQConfig())
    y1 = tm.apply(eq, torch.from_numpy(toks))
    scale = float(y0.abs().max()) + 1e-6
    assert float((y1 - y0).abs().max()) / scale < 5e-3
    jeq = jax_to_numpy(jax_apply_dfq(jp, jm.dfq_plan(), JaxDFQConfig()))
    for path, t in leaves(eq):
        close(t, get_leaf(jeq, path), tol=1e-6, msg=str(path))


@pytest.mark.parametrize("recipe", ["dfq-int8", "serve-w8a16"])
@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_quantize_matches_jax(pairs, arch, recipe):
    """``repro_torch.quantize`` against ``repro.quantize`` on the same
    weights, leaf by leaf. dfq-int8's bias correction moves the mixers'
    in/out biases (mamba2); on the hybrid it corrects nothing, as in the
    reference, whose stats nest under ``mamba`` / ``shared_<seg>``."""
    jm, jp, tm, tp = pairs[arch]
    jq = repro.quantize(jm, params=jp, recipe=recipe)
    tq = repro_torch.quantize(tm, tp, recipe=recipe, device="cpu")
    want = []
    if recipe == "dfq-int8":
        rec = tq.stage_record("bias_correct")["metrics"]
        want = ["ssm_in_proj", "ssm_out_proj"] if arch == MAMBA else []
        assert rec["sites_corrected"] == want
    assert_quantized_equal(tq, jq, summed_biases(tm.dfq_plan(), want))


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_artifact_loads_in_both_packages(pairs, arch, tmp_path):
    """A serve-w8a8 artifact saved by each package loads in the other: the
    config, every leaf, and the loaded model's prefill + decode logits."""
    jm, jp, tm, tp = pairs[arch]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jq = repro.quantize(jm, params=jp, recipe="serve-w8a8")
    jq.save(jdir)
    qm = QuantizedModel.load(jdir, device="cpu")
    assert qm.cfg == get_config(arch, smoke=True)
    assert_quantized_equal(qm, jq)
    tq = repro_torch.quantize(tm, tp, recipe="serve-w8a8", device="cpu")
    tq.save(tdir)
    back = repro.QuantizedModel.load(tdir)
    for f in dataclasses.fields(tq.cfg):
        assert getattr(back.cfg, f.name) == getattr(tq.cfg, f.name), f.name
    assert_quantized_equal(tq, back)
    toks = np.random.RandomState(4).randint(0, 256, (2, 12)).astype(np.int32)
    jc = back.model.init_cache(2, 16, dtype=jnp.float32)
    tc = qm.init_cache(2, 16, device="cpu", dtype=torch.float32)
    jl, jc = jax.jit(back.model.prefill)(back.params,
                                         jnp.asarray(toks[:, :8]), jc)
    tl, tc = qm.prefill(torch.from_numpy(toks[:, :8]).long(), tc)
    close(tl, jl, tol=1e-4)
    decode = jax.jit(back.model.decode_step)
    for t in range(8, 12):
        jl, jc = decode(back.params, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = qm.decode_step(torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        close(tl, jl, tol=1e-4, msg=f"step {t}")


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_full_width_configs_build_as_the_reference(arch):
    """Every config field the reference's at full width and smoke size, the
    derived dims (d_inner, ssm_heads), the parameter count its and inside
    ``test_models_smoke.py``'s public range, the model's plan its, and
    long_500k applicable (an SSM backbone)."""
    from repro_torch.models import SHAPE_BY_NAME, shape_applicable

    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                                 smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert (cfg.d_inner, cfg.ssm_heads, cfg.param_count()) == (
            jcfg.d_inner, jcfg.ssm_heads, jcfg.param_count())
    cfg = get_config(arch)
    assert 2e9 <= cfg.param_count() <= 3.5e9
    assert shape_applicable(cfg, SHAPE_BY_NAME["long_500k"])[0]
    assert plan_repr(build_model(cfg).dfq_plan()) == plan_repr(
        jax_build_model(jax_get_config(arch)).dfq_plan())
    din, H, G, S, d_proj, _ = mamba.ssm_dims(cfg)
    assert d_proj == {MAMBA: 10576, ZAMBA: 10448}[arch]


def test_init_draws_the_reference_layout():
    """``LMModel.init`` for both families: the reference's tree (paths and
    shapes), dt_bias the inverse softplus of a dt in [1e-3, 1e-1]."""
    for arch in (MAMBA, ZAMBA):
        cfg = get_config(arch, smoke=True)
        tp = build_model(cfg).init(0, device="cpu")
        jp = jax_build_model(jax_get_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0))
        tl, jl = dict(leaves(tp)), dict(leaves(jax_to_numpy(jp)))
        assert sorted(tl) == sorted(jl)
        for k in tl:
            assert tuple(tl[k].shape) == jl[k].shape, k
            assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype), k
        dt = torch.nn.functional.softplus(tp["blocks"]["mixer"]["dt_bias"])
        assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001


def test_cli_quantizes_the_new_archs(tmp_path, capsys):
    """``python -m repro_torch.pipeline.cli --arch <ssm arch> --smoke
    --save``: the artifact loads in the JAX package."""
    from repro_torch.pipeline.cli import main

    for arch in (MAMBA, ZAMBA):
        d = str(tmp_path / arch)
        assert main(["--arch", arch, "--smoke", "--recipe", "serve-w8a16",
                     "--device", "cpu", "--save", d]) == 0
        assert os.path.exists(os.path.join(d, "quantized_model.json"))
        assert repro.QuantizedModel.load(d).cfg.name == f"{arch}-smoke"
    assert "saved QuantizedModel" in capsys.readouterr().out
