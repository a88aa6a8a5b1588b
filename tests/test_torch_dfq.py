"""The port's DFQ core (``repro_torch.core``) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and
its ``repro_torch`` counterpart on the CPU. The rewrites are abs, max,
sqrt, multiply and divide in float32, each correctly rounded, so their
outputs are bit-equal — with one exception: a bias shift that is a matrix
product (``absorb_v_bias``, ``absorb_dense``, the LayerNorm shift of
``fold_norm``) sums in XLA's order on one side and PyTorch's on the other.
Those outputs are held to the dot-product rounding bound
``n · 2⁻²³ · (|c| @ |W|)`` instead (n = the contracted length), and the
test prints the measured maximum.

The weights are made to need the transforms: the JAX init goes through
``repro.core.adversarial.hostile_rescale``, and the norm gains and the
qkv / output biases are random, so folding and absorption are not no-ops.
Function preservation is checked on the port alone, through its own
layers and its cache-free ``LMModel.apply``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_port import hostile_jax_params
from _torch_port import jax_to_numpy as _numpy
from repro.core import cle as jcle
from repro.core import bias_absorption as jba
from repro.core import quantizer as jq
from repro.core.dfq import DFQConfig as JaxDFQConfig
from repro.core.dfq import apply_dfq as jax_apply_dfq
from repro.core.dfq import run_plan_ops as jax_run_plan_ops
from repro.core.graph import NormFoldOp as JaxNormFoldOp

from repro_torch import get_config
from repro_torch.core import (
    DFQConfig,
    NormFoldOp,
    QuantSpec,
    absorb_dense,
    absorb_v_bias,
    absorption_amount,
    apply_dfq,
    compute_qparams,
    dequantize,
    equalization_scales,
    equalize_dense_pair,
    equalize_qk,
    equalize_vo,
    fake_quant,
    fold_norm,
    quantize,
    run_plan_ops,
    sqnr_db,
)
from repro_torch.core.tree import get_path, has_path, set_path
from repro_torch.models import build_model
from repro_torch.models.layers import AttnDims, causal_attention_block
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b"


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _eq(jax_out, torch_out, what=""):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out),
                                  err_msg=what)


def _dot_bound(c, w, n):
    """n · 2⁻²³ · (|c| @ |w|): the rounding bound of two float32 sums of the
    same n products taken in different orders."""
    return n * 2.0 ** -23 * np.einsum("...n,...no->...o", np.abs(c),
                                      np.abs(w))


def _spread(rng, shape, axis=-1, decades=1.5):
    """Gaussian weights with per-channel ranges spread over ~decades."""
    w = rng.randn(*shape)
    s = np.exp(rng.randn(shape[axis]) * decades)
    bshape = [1] * len(shape)
    bshape[axis] = shape[axis]
    return (w * s.reshape(bshape)).astype(np.float32)


# ---------------------------------------------------------------- eq. 11

def test_equalization_scales_bit_equal():
    rng = np.random.RandomState(0)
    r1 = np.abs(_spread(rng, (3, 257), decades=3.0))
    r2 = np.abs(_spread(rng, (3, 257), decades=3.0))
    r1[0, :5] = 0.0                                  # dead channels
    r2[1, 5:9] = 0.0
    _eq(jcle.equalization_scales(jnp.asarray(r1), jnp.asarray(r2)),
        equalization_scales(_t(r1), _t(r2)))


def test_equalization_scales_closed_form():
    s = equalization_scales(torch.tensor([1.0, 4.0, 0.25, 0.0]),
                            torch.tensor([1.0, 1.0, 4.0, 1.0]))
    np.testing.assert_allclose(s.numpy(), [1.0, 2.0, 0.25, 1.0], rtol=1e-6)


# ------------------------------------------------------------ dense pair

@pytest.mark.parametrize("with_bias", [True, False])
def test_dense_pair_bit_equal(with_bias):
    rng = np.random.RandomState(1)
    w1 = _spread(rng, (2, 24, 48))
    w2 = _spread(rng, (2, 48, 16), axis=-2)
    b1 = rng.randn(2, 48).astype(np.float32) if with_bias else None
    rj = jcle.equalize_dense_pair(jnp.asarray(w1),
                                  None if b1 is None else jnp.asarray(b1),
                                  jnp.asarray(w2))
    rt = equalize_dense_pair(_t(w1), None if b1 is None else _t(b1), _t(w2))
    for name in ("w1", "w2", "scales"):
        _eq(getattr(rj, name), getattr(rt, name), name)
    if with_bias:
        _eq(rj.b1, rt.b1, "b1")
    else:
        assert rt.b1 is None


def test_dense_pair_preserves_the_gated_mlp_and_matches_ranges():
    """up↔down CLE through a SwiGLU gate is exact for any scales; after it
    r_i^(1) = r_i^(2) and the limiting channel is shared (eq. 10)."""
    rng = np.random.RandomState(2)
    d, f = 16, 64
    wg, wd = _t(rng.randn(d, f)), _t(rng.randn(f, d))
    wu = _t(_spread(rng, (d, f), decades=3.0))
    x = _t(rng.randn(32, d))
    y0 = (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd
    res = equalize_dense_pair(wu, None, wd)
    y1 = (torch.nn.functional.silu(x @ wg) * (x @ res.w1)) @ res.w2
    torch.testing.assert_close(y1, y0, rtol=2e-4, atol=1e-4)
    r1, r2 = res.w1.abs().amax(0), res.w2.abs().amax(1)
    torch.testing.assert_close(r1, r2, rtol=1e-5, atol=0)
    assert int(r1.argmax()) == int(r2.argmax())


# ----------------------------------------------------------- attention pairs

NQ, NKV, HD, D = 8, 2, 16, 32          # GQA: groups of 4 query heads


def _attn_weights(seed, spread=1.5, lead=()):
    rng = np.random.RandomState(seed)
    noise = np.exp(rng.randn(NKV * HD) * spread)
    return {
        "wq": _t(rng.randn(*lead, D, NQ * HD) / np.sqrt(D)),
        "wk": _t(rng.randn(*lead, D, NKV * HD) * noise / np.sqrt(D)),
        "wv": _t(rng.randn(*lead, D, NKV * HD) * noise),
        "wo": _t(rng.randn(*lead, NQ * HD, D)),
        "bq": _t(rng.randn(*lead, NQ * HD)),
        "bk": _t(rng.randn(*lead, NKV * HD)),
        "bv": _t(rng.randn(*lead, NKV * HD)),
        "bo": _t(rng.randn(*lead, D)),
    }


def _attend(p, x, rope):
    return causal_attention_block(p, x, AttnDims(n_q=NQ, n_kv=NKV,
                                                 head_dim=HD, rope=rope))


def test_vo_pair_bit_equal_and_exact():
    p = _attn_weights(0, lead=(3,))
    j = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    rj = jcle.equalize_vo(j["wv"], j["bv"], j["wo"], n_q=NQ, n_kv=NKV,
                          head_dim=HD)
    rt = equalize_vo(p["wv"], p["bv"], p["wo"], n_q=NQ, n_kv=NKV, head_dim=HD)
    for name in ("w1", "b1", "w2", "scales"):
        _eq(getattr(rj, name), getattr(rt, name), name)
    # exact through GQA attention (layer 0 of the stack)
    x = _t(np.random.RandomState(9).randn(2, 8, D))
    p0 = {k: v[0] for k, v in p.items()}
    y0 = _attend(p0, x, rope=True)
    y1 = _attend({**p0, "wv": rt.w1[0], "bv": rt.b1[0], "wo": rt.w2[0]}, x,
                 rope=True)
    torch.testing.assert_close(y1, y0, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("n_kv", [2, 8], ids=["group4", "group1"])
def test_qk_pair_bit_equal_and_exact(rope, n_kv):
    p = _attn_weights(3 + n_kv, spread=2.0)
    wk = p["wk"] if n_kv == NKV else _t(np.random.RandomState(5).randn(
        D, n_kv * HD) * np.exp(np.random.RandomState(6).randn(n_kv * HD)))
    bk = p["bk"] if n_kv == NKV else _t(np.random.RandomState(7).randn(
        n_kv * HD))
    rj = jcle.equalize_qk(jnp.asarray(p["wq"].numpy()),
                          jnp.asarray(p["bq"].numpy()),
                          jnp.asarray(wk.numpy()), jnp.asarray(bk.numpy()),
                          n_q=NQ, n_kv=n_kv, head_dim=HD, rope=rope)
    rt = equalize_qk(p["wq"], p["bq"], wk, bk, n_q=NQ, n_kv=n_kv,
                     head_dim=HD, rope=rope)
    for name in ("wq", "bq", "wk", "bk", "scales"):
        _eq(getattr(rj, name), getattr(rt, name), name)
    if n_kv == NKV:                    # exact through roped GQA attention
        x = _t(np.random.RandomState(10).randn(2, 8, D))
        y0 = _attend(p, x, rope)
        y1 = _attend({**p, "wq": rt.wq, "bq": rt.bq, "wk": rt.wk,
                      "bk": rt.bk}, x, rope)
        torch.testing.assert_close(y1, y0, rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------- norm folding

@pytest.mark.parametrize("layernorm", [False, True])
def test_fold_norm_matches_jax_and_preserves_function(layernorm):
    rng = np.random.RandomState(11)
    d = 16
    g = np.exp(rng.randn(2, d)).astype(np.float32)
    beta = rng.randn(2, d).astype(np.float32) if layernorm else None
    ws = [rng.randn(2, d, 8).astype(np.float32),
          rng.randn(2, d, 4).astype(np.float32)]
    bs = [rng.randn(2, 8).astype(np.float32), None]
    oj = jcle.fold_norm(jnp.asarray(g), [jnp.asarray(w) for w in ws],
                        None if beta is None else jnp.asarray(beta),
                        [None if b is None else jnp.asarray(b) for b in bs])
    ot = fold_norm(_t(g), [_t(w) for w in ws],
                   None if beta is None else _t(beta),
                   [None if b is None else _t(b) for b in bs])
    _eq(oj[0], ot[0], "ones")
    for wj, wt in zip(oj[2], ot[2]):
        _eq(wj, wt, "folded weight")
    if not layernorm:
        assert ot[1] is None and ot[3][1] is None
        _eq(oj[3][0], ot[3][0], "bias")
    else:
        _eq(oj[1], ot[1], "zeros")
        for w, b, bj, bt in zip(ws, bs, oj[3], ot[3]):
            bound = _dot_bound(beta, w, d) + (0 if b is None else
                                              np.spacing(np.abs(b)))
            assert (np.abs(bt.numpy() - np.asarray(bj)) <= bound).all()
    # function preserved: (norm(x)·γ + β) @ W + b == norm(x) @ W' + b'
    x = _t(rng.randn(2, 5, d))
    xn = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
    for i, (w, b) in enumerate(zip(ws, bs)):
        shifted = xn * _t(g)[:, None] + (0 if beta is None
                                         else _t(beta)[:, None])
        y0 = shifted @ _t(w) + (0 if b is None else _t(b)[:, None])
        y1 = xn @ ot[2][i] + (0 if ot[3][i] is None else ot[3][i][:, None])
        torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ bias absorption

def test_absorb_v_bias_matches_jax_and_is_exact():
    p = _attn_weights(12, lead=(2,))
    rj = jba.absorb_v_bias(jnp.asarray(p["bv"].numpy()),
                           jnp.asarray(p["wo"].numpy()),
                           jnp.asarray(p["bo"].numpy()), n_q=NQ, n_kv=NKV,
                           head_dim=HD)
    rt = absorb_v_bias(p["bv"], p["wo"], p["bo"], n_q=NQ, n_kv=NKV,
                       head_dim=HD)
    _eq(rj.b1, rt.b1, "bv zeroed")
    c_full = np.repeat(p["bv"].numpy().reshape(2, NKV, 1, HD), NQ // NKV,
                       axis=2).reshape(2, NQ * HD)
    bound = (_dot_bound(c_full, p["wo"].numpy(), NQ * HD)
             + np.spacing(np.abs(np.asarray(rj.b2))))
    diff = np.abs(rt.b2.numpy() - np.asarray(rj.b2))
    print(f"absorb_v_bias bo: max |diff| {diff.max():.3g}")
    assert (diff <= bound).all()
    x = _t(np.random.RandomState(13).randn(2, 8, D))
    p0 = {k: v[0] for k, v in p.items()}
    y0 = _attend(p0, x, rope=True)
    y1 = _attend({**p0, "bv": rt.b1[0], "bo": rt.b2[0]}, x, rope=True)
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)


def test_absorb_dense_matches_jax():
    rng = np.random.RandomState(14)
    beta = rng.randn(2, 32).astype(np.float32) * 3
    gamma = rng.randn(2, 32).astype(np.float32)
    b1, b2 = rng.randn(2, 32).astype(np.float32), rng.randn(2, 8).astype(np.float32)
    w2 = rng.randn(2, 32, 8).astype(np.float32)
    cj = jba.absorption_amount(jnp.asarray(beta), jnp.asarray(gamma), 3.0)
    ct = absorption_amount(_t(beta), _t(gamma), 3.0)
    _eq(cj, ct, "c")
    assert bool((ct >= 0).all()) and bool((ct > 0).any())
    rj = jba.absorb_dense(jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2), cj)
    rt = absorb_dense(_t(b1), _t(w2), _t(b2), ct)
    _eq(rj.b1, rt.b1, "b1")
    bound = _dot_bound(ct.numpy(), w2, 32) + np.spacing(np.abs(np.asarray(rj.b2)))
    assert (np.abs(rt.b2.numpy() - np.asarray(rj.b2)) <= bound).all()


# --------------------------------------------------------------- quantizer

@pytest.mark.parametrize("bits,symmetric,axis", [(8, False, None),
                                                 (8, True, None),
                                                 (8, True, -1), (6, False, -1)])
def test_quantizer_matches_jax(bits, symmetric, axis):
    rng = np.random.RandomState(bits + 2 * symmetric)
    x = _spread(rng, (2, 32, 24), decades=1.0)
    js = jq.QuantSpec(bits=bits, symmetric=symmetric, per_channel_axis=axis)
    ts = QuantSpec(bits=bits, symmetric=symmetric, per_channel_axis=axis)
    qj = jq.compute_qparams(jnp.asarray(x), js)
    qt = compute_qparams(_t(x), ts)
    _eq(qj.scale, qt.scale, "scale")
    _eq(qj.zero_point, qt.zero_point, "zero point")
    _eq(jq.quantize(jnp.asarray(x), qj), quantize(_t(x), qt), "payload")
    _eq(jq.dequantize(jq.quantize(jnp.asarray(x), qj), qj),
        dequantize(quantize(_t(x), qt), qt), "dequantized")
    _eq(jq.fake_quant(jnp.asarray(x), js), fake_quant(_t(x), ts), "fake quant")
    sj = float(jq.sqnr_db(jnp.asarray(x), jq.fake_quant(jnp.asarray(x), js)))
    st = float(sqnr_db(_t(x), fake_quant(_t(x), ts)))
    assert abs(sj - st) < 1e-4


# --------------------------------------------------------- plan and executor

@pytest.fixture(scope="module")
def hostile():
    jm, jp = hostile_jax_params(ARCH)
    cfg = get_config(f"{ARCH}-smoke")
    return jm, jp, build_model(cfg), from_jax_numpy(_numpy(jp), cfg,
                                                    device="cpu")


def _fields(op):
    return {f.name: (tuple(v) if isinstance(v, list) else v)
            for f in dataclasses.fields(op)
            for v in [getattr(op, f.name)]}


def test_dfq_plan_matches_jax(hostile):
    jm, _, tm, _ = hostile
    jplan, tplan = jm.dfq_plan(), tm.dfq_plan()
    assert [type(op).__name__ for op in tplan.ops] == \
           [type(op).__name__ for op in jplan.ops]
    for jop, top in zip(jplan.ops, tplan.ops):
        assert _fields(top) == _fields(jop), type(top).__name__
    assert [dataclasses.astuple(s) for s in tplan.sites] == \
           [dataclasses.astuple(s) for s in jplan.sites]
    assert tplan.name == jplan.name
    assert sum(isinstance(op, NormFoldOp) for op in tplan.ops) == \
           sum(isinstance(op, JaxNormFoldOp) for op in jplan.ops) == 2


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _bo_bound(params, cfg, bo_ref):
    """The dot-product bound of the value-bias shift ``c_full @ wo``, from
    the bv and wo that the absorption reads (``params``), plus one ulp of
    the final ``bo + shift``."""
    attn = params["blocks"]["attn"]
    bv, wo = attn["bv"].numpy(), attn["wo"].numpy()
    c_full = np.repeat(bv.reshape(bv.shape[0], cfg.n_kv_heads, 1,
                                  cfg.head_dim),
                       cfg.n_heads // cfg.n_kv_heads, axis=2)
    c_full = c_full.reshape(bv.shape[0], -1)
    return _dot_bound(c_full, wo, c_full.shape[-1]) + np.spacing(np.abs(bo_ref))


FOLD, CLE, ABSORB = ("NormFoldOp",), ("DensePairOp", "VOPairOp", "QKPairOp"), \
    ("VBiasAbsorbOp", "HighBiasAbsorbOp")


def _kinds(plan, names):
    return tuple({type(op) for op in plan.ops if type(op).__name__ in names})


@pytest.mark.parametrize("interleaved", [True, False],
                         ids=["apply_dfq", "staged"])
def test_run_plan_ops_matches_jax(hostile, interleaved):
    """Every leaf bit-equal to the JAX executor's but ``bo``, whose value
    bias shift is a matrix product (dot-product bound, module docstring).
    ``staged`` is the pipeline's schedule: fold, then CLE twice, then
    absorb."""
    jm, jp, tm, tp = hostile
    jplan, tplan = jm.dfq_plan(), tm.dfq_plan()
    if interleaved:
        je = jax_apply_dfq(jp, jplan, JaxDFQConfig())
        te = apply_dfq(tp, tplan, DFQConfig())
        # the absorption runs in the first pass, after fold and CLE once
        at_absorb = run_plan_ops(tp, tplan, DFQConfig(),
                                 kinds=_kinds(tplan, FOLD + CLE))
    else:
        je, te = jp, tp
        for names, it in ((FOLD, 1), (CLE, 2), (ABSORB, 1)):
            if names is ABSORB:
                at_absorb = te
            je = jax_run_plan_ops(je, jplan, JaxDFQConfig(),
                                  kinds=_kinds(jplan, names), iterations=it)
            te = run_plan_ops(te, tplan, DFQConfig(),
                              kinds=_kinds(tplan, names), iterations=it)
    jl, tl, l0 = (dict(_leaves(_numpy(je))), dict(_leaves(te)),
                  dict(_leaves(_numpy(jp))))
    assert sorted(jl) == sorted(tl)
    for path, t in tl.items():
        if path == ("blocks", "attn", "bo"):
            diff = np.abs(t.numpy() - jl[path])
            print(f"bo: max |diff| {diff.max():.3g}")
            assert (diff <= _bo_bound(at_absorb, tm.cfg, jl[path])).all()
        else:
            np.testing.assert_array_equal(t.numpy(), jl[path],
                                          err_msg=str(path))
    changed = [p for p in tl if not np.array_equal(jl[p], l0[p])]
    assert len(changed) >= 12, changed      # the transforms did real work


def test_apply_dfq_preserves_the_smoke_model(hostile):
    """The port's fp32 eval forward before and after ``apply_dfq``: the
    same logits within atol 2e-4 (relative to max |logit| ~ 1: float32
    rounding through rescaled weights), and the port's forward agrees with
    the JAX ``apply`` on the same weights within atol 1e-5."""
    jm, jp, tm, tp = hostile
    toks = np.random.RandomState(0).randint(0, 256, (2, 16))
    y0 = tm.apply(tp, torch.from_numpy(toks))
    y1 = tm.apply(apply_dfq(tp, tm.dfq_plan(), DFQConfig()),
                  torch.from_numpy(toks))
    assert float(y0.abs().max()) > 0.1
    torch.testing.assert_close(y1, y0, rtol=0, atol=2e-4)
    yj, _ = jm.apply(jp, jnp.asarray(toks))
    np.testing.assert_allclose(y0.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


def test_dfq_is_idempotent(hostile):
    """Equalizing an already-equalized model is (nearly) a no-op: the fixed
    point of eq. 11 is s = 1."""
    _, _, tm, tp = hostile
    once = apply_dfq(tp, tm.dfq_plan(), DFQConfig())
    twice = apply_dfq(once, tm.dfq_plan(), DFQConfig())
    for (pa, a), (pb, b) in zip(_leaves(once), _leaves(twice)):
        assert pa == pb
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


def test_tree_paths():
    tree = {"a": {"b": torch.zeros(2)}, "c": torch.ones(1)}
    new = set_path(tree, ("a", "b"), torch.ones(2))
    assert torch.equal(get_path(new, ("a", "b")), torch.ones(2))
    assert torch.equal(get_path(tree, ("a", "b")), torch.zeros(2))
    assert new["c"] is tree["c"]
    assert has_path(tree, ("a", "b")) and not has_path(tree, ("a", "x"))
    with pytest.raises(ValueError, match="empty"):
        set_path(tree, (), 1)
