"""The port's CNN half of the DFQ core against the JAX package's: BatchNorm
folding, the conv-chain CLE, conv bias absorption, high-bias absorption
through ``run_plan_ops``, ``DFQConfig``'s fields, ``hostile_rescale`` and
the SAME-padded convolution.

The same numpy inputs, made from a seed, go through the JAX function and
its ``repro_torch`` counterpart on the CPU. Folding, the range maxima, the
chain's rescales and its cumulative scales are abs, max, sqrt, multiply
and divide in float32, each correctly rounded: bit-equal, and the chain
runs as many passes as JAX's. A bias shift that is a sum of products
(``absorb_conv``, ``absorb_dense``) is held to the float32 summation bound
``n · 2⁻²³ · Σ|c·w|`` (n = the number of terms); a convolution to
``K · 2⁻²² · (|x| * |w|)`` with K = the taps a window sums; and
``hostile_rescale``'s scales, exponentials of ``prng.normal``'s draws
(within 4 ulp of JAX's), to 8 ulp relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_port import jax_to_numpy
from repro.configs import get_config as jax_get_config
from repro.core import adversarial as jadv
from repro.core import bias_absorption as jba
from repro.core import bn_folding as jbn
from repro.core import cle as jcle
from repro.core import graph as jgraph
from repro.core.dfq import DFQConfig as JaxDFQConfig
from repro.core.dfq import run_plan_ops as jax_run_plan_ops
from repro.models import build_model as jax_build_model
from repro.models.cnn import _conv as jax_conv

from repro_torch.core import (
    BNParams,
    ConvLayer,
    DFQConfig,
    DFQPlan,
    DensePairOp,
    HighBiasAbsorbOp,
    QuantSpec,
    absorb_conv,
    equalize_conv_chain,
    fake_quant,
    fold_bn_conv,
    hostile_rescale,
    run_plan_ops,
    sqnr_db,
)
from repro_torch.core.cle import _in_ranges, _out_ranges, _scale_in, _scale_out
from repro_torch.models.cnn import _conv

F32_ULP = 2.0 ** -23


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _eq(t, j, what=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


def _sum_bound(terms_abs_sum, n):
    """Two float32 sums of n terms in other orders differ by at most about
    n · 2⁻²³ of the sum of the terms' magnitudes."""
    return n * F32_ULP * terms_abs_sum + 1e-30


# ---------------------------------------------------------------- BN folding
@pytest.mark.parametrize("shape,with_bias", [
    ((3, 3, 4, 6), False), ((1, 1, 6, 9), True), ((3, 3, 1, 7), False),
    ((5, 8), True)])
def test_fold_bn_conv_bit_equal(shape, with_bias):
    rng = np.random.RandomState(sum(shape))
    c = shape[-1]
    w = rng.randn(*shape).astype(np.float32)
    b = rng.randn(c).astype(np.float32) if with_bias else None
    gamma = (rng.randn(c) * 2).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = np.exp(rng.randn(c) * 3).astype(np.float32)     # 1e-4 .. 1e4
    jf = jbn.fold_bn_conv(jnp.asarray(w), None if b is None else jnp.asarray(b),
                          jbn.BNParams(*(jnp.asarray(a) for a in
                                         (gamma, beta, mean, var))))
    tf = fold_bn_conv(_t(w), None if b is None else _t(b),
                      BNParams(_t(gamma), _t(beta), _t(mean), _t(var)))
    for name in ("w", "b", "act_mean", "act_std"):
        _eq(getattr(tf, name), getattr(jf, name), name)


# ------------------------------------------------------------ conv-chain CLE
def _layer_pair(kind, seed):
    rng = np.random.RandomState(seed)
    shape = {"conv": (3, 3, 5, 6), "depthwise": (3, 3, 1, 6),
             "dense": (6, 4)}[kind]
    w = (rng.randn(*shape) * np.exp(rng.randn(shape[-1]))).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    return w, b


@pytest.mark.parametrize("kind", ["conv", "depthwise", "dense"])
def test_ranges_and_scales_bit_equal(kind):
    w, b = _layer_pair(kind, 3)
    s_out = np.exp(np.random.RandomState(4).randn(w.shape[-1])).astype(np.float32)
    n_in = w.shape[-1] if kind == "depthwise" else w.shape[-2]
    s_in = np.exp(np.random.RandomState(5).randn(n_in)).astype(np.float32)
    jl = jcle.ConvLayer(jnp.asarray(w), jnp.asarray(b), kind)
    tl = ConvLayer(_t(w), _t(b), kind)
    _eq(_out_ranges(tl), jcle._out_ranges(jl), "out ranges")
    _eq(_in_ranges(tl), jcle._in_ranges(jl), "in ranges")
    jo, to = jcle._scale_out(jl, jnp.asarray(s_out)), _scale_out(tl, _t(s_out))
    _eq(to.w, jo.w, "scale_out w")
    _eq(to.b, jo.b, "scale_out b")
    ji, ti = jcle._scale_in(jl, jnp.asarray(s_in)), _scale_in(tl, _t(s_in))
    _eq(ti.w, ji.w, "scale_in w")
    assert ti.b is tl.b


def _jax_chain(seed):
    """``tests/test_core_cle.py``'s TestConvChain chain: expand 1x1 with
    channel spreads e^(2·N(0,1)), depthwise 3x3, project 1x1 without bias,
    and an input [2, 8, 8, 8]."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 8)
    c0, c1, c2 = 8, 16, 8
    spread = jnp.exp(jax.random.normal(ks[6], (c1,)) * 2.0)
    expand = jcle.ConvLayer(jax.random.normal(ks[0], (1, 1, c0, c1)) * spread,
                            jax.random.normal(ks[1], (c1,)) * 0.1, "conv")
    dw = jcle.ConvLayer(jax.random.normal(ks[2], (3, 3, 1, c1)),
                        jax.random.normal(ks[3], (c1,)) * 0.1, "depthwise")
    proj = jcle.ConvLayer(jax.random.normal(ks[4], (1, 1, c1, c2)), None,
                          "conv")
    x = jax.random.normal(ks[5], (2, 8, 8, c0))
    return np.asarray(x), [expand, dw, proj]


def _port_layers(jlayers):
    return [ConvLayer(_t(l.w), None if l.b is None else _t(l.b), l.kind)
            for l in jlayers]


def _jax_passes(jlayers, iterations):
    """The passes JAX's equalize_conv_chain runs (it does not return the
    count): the fewest iterations whose result equals the full call's."""
    full, _ = jcle.equalize_conv_chain(jlayers, iterations)
    for k in range(1, iterations + 1):
        part, _ = jcle.equalize_conv_chain(jlayers, k)
        if all(np.array_equal(np.asarray(a.w), np.asarray(b.w))
               for a, b in zip(part, full)):
            return k
    raise AssertionError("no prefix of the passes reproduces the result")


@pytest.mark.parametrize("seed,iterations", [(0, 20), (1, 50), (2, 20),
                                             (3, 3)])
def test_equalize_conv_chain_bit_equal_with_jax_passes(seed, iterations):
    _, jlayers = _jax_chain(seed)
    jnew, jcum = jcle.equalize_conv_chain(jlayers, iterations)
    tnew, tcum, passes = equalize_conv_chain(_port_layers(jlayers), iterations)
    for i, (t, j) in enumerate(zip(tnew, jnew)):
        _eq(t.w, j.w, f"layer {i} w")
        if j.b is None:
            assert t.b is None
        else:
            _eq(t.b, j.b, f"layer {i} b")
    for i, (t, j) in enumerate(zip(tcum, jcum)):
        _eq(t, j, f"cum {i}")
    assert passes == _jax_passes(jlayers, iterations)
    assert passes > 1                         # the chain did iterate


def _apply_chain(x, layers):
    """TestConvChain._apply in the port: SAME convs at stride 1, ReLU
    between layers."""
    h = x
    for i, layer in enumerate(layers):
        if layer.kind == "dense":
            h = h.reshape(h.shape[0], -1) @ layer.w
        else:
            groups = layer.w.shape[-1] if layer.kind == "depthwise" else 1
            h = _conv(h, layer.w, 1, groups)
        if layer.b is not None:
            h = h + layer.b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def test_chain_preserves_function():
    x, jlayers = _jax_chain(0)
    layers = _port_layers(jlayers)
    y0 = _apply_chain(_t(x), layers)
    y1 = _apply_chain(_t(x), equalize_conv_chain(layers).layers)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=5e-4, atol=5e-4)


def test_chain_converges_ranges():
    _, jlayers = _jax_chain(1)
    new = equalize_conv_chain(_port_layers(jlayers), iterations=50).layers
    for i in range(len(new) - 1):
        np.testing.assert_allclose(_out_ranges(new[i]).numpy(),
                                   _in_ranges(new[i + 1]).numpy(), rtol=1e-2)


def test_chain_improves_quantized_sqnr():
    x, jlayers = _jax_chain(2)
    layers = _port_layers(jlayers)
    spec = QuantSpec(bits=8)
    y_fp = _apply_chain(_t(x), layers)

    def q(ls):
        return [l._replace(w=fake_quant(l.w, spec)) for l in ls]

    new = equalize_conv_chain(layers).layers
    before = float(sqnr_db(y_fp, _apply_chain(_t(x), q(layers))))
    after = float(sqnr_db(y_fp, _apply_chain(_t(x), q(new))))
    assert after > before + 6.0


# ----------------------------------------------------------- bias absorption
@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("with_b2", [False, True])
def test_absorb_conv_matches_jax(depthwise, with_b2):
    rng = np.random.RandomState(10 + depthwise + 2 * with_b2)
    c_in, c_out = 12, 12 if depthwise else 7
    w2 = rng.randn(3, 3, 1 if depthwise else c_in, c_out).astype(np.float32)
    b1 = (rng.randn(c_in) * 3).astype(np.float32)
    b2 = rng.randn(c_out).astype(np.float32) if with_b2 else None
    c = np.maximum(0, rng.randn(c_in) * 2).astype(np.float32)
    jr = jba.absorb_conv(jnp.asarray(b1), jnp.asarray(w2),
                         None if b2 is None else jnp.asarray(b2),
                         jnp.asarray(c), depthwise=depthwise)
    tr = absorb_conv(_t(b1), _t(w2), None if b2 is None else _t(b2), _t(c),
                     depthwise=depthwise)
    _eq(tr.b1, jr.b1, "b1")
    _eq(tr.c, jr.c, "c")
    if depthwise:
        terms = np.abs(c) * np.abs(w2[:, :, 0, :]).sum(axis=(0, 1))
        n = 9
    else:
        terms = np.einsum("i,hwio->o", np.abs(c), np.abs(w2))
        n = 9 * c_in
    bound = _sum_bound(terms, n) + (0 if b2 is None else
                                    F32_ULP * (np.abs(b2) + terms))
    diff = np.abs(tr.b2.numpy() - np.asarray(jr.b2))
    print(f"absorb_conv b2: max |diff| {diff.max():.3g}")
    assert (diff <= bound).all()


def _hba_params(seed):
    rng = np.random.RandomState(seed)
    n, d_out = 10, 6
    return {"l1": {"b": (rng.randn(n) * 4).astype(np.float32)},
            "l2": {"w": rng.randn(n, d_out).astype(np.float32),
                   "b": rng.randn(d_out).astype(np.float32)},
            "bn": {"beta": (rng.randn(n) * 4).astype(np.float32),
                   "gamma": rng.randn(n).astype(np.float32)}}


@pytest.mark.parametrize("config", [
    {}, {"n_sigma_absorb": 1.0}, {"bias_absorb": False}])
def test_high_bias_absorb_op_matches_jax_run_plan_ops(config):
    """``run_plan_ops`` runs a ``HighBiasAbsorbOp`` as the JAX package does
    (``src/repro/core/dfq.py``): c = max(0, β − n·|γ|) taken from b1 and
    pushed through W2 into b2; switched off by ``bias_absorb=False``."""
    p = _hba_params(7)
    paths = dict(b1=("l1", "b"), w2=("l2", "w"), b2=("l2", "b"),
                 beta=("bn", "beta"), gamma=("bn", "gamma"))
    jout = jax_run_plan_ops(
        jax.tree.map(jnp.asarray, p),
        jgraph.DFQPlan(ops=(jgraph.HighBiasAbsorbOp(**paths),), sites=()),
        JaxDFQConfig(**config))
    tout = run_plan_ops(
        {k: {kk: _t(v) for kk, v in d.items()} for k, d in p.items()},
        DFQPlan(ops=(HighBiasAbsorbOp(**paths),), sites=()),
        DFQConfig(**config))
    jl = jax_to_numpy(jout)
    for k in ("l1", "l2", "bn"):
        for kk in p[k]:
            if (k, kk) == ("l2", "b"):
                continue
            _eq(tout[k][kk], jl[k][kk], f"{k}.{kk}")
    n_sigma = config.get("n_sigma_absorb", 3.0)
    c = np.maximum(0, p["bn"]["beta"] - np.float32(n_sigma)
                   * np.abs(p["bn"]["gamma"]))
    terms = np.abs(c) @ np.abs(p["l2"]["w"])
    bound = (_sum_bound(terms, len(c))
             + F32_ULP * (np.abs(p["l2"]["b"]) + terms))
    diff = np.abs(tout["l2"]["b"].numpy() - jl["l2"]["b"])
    assert (diff <= bound).all()
    changed = not np.array_equal(jl["l1"]["b"], p["l1"]["b"])
    assert changed == config.get("bias_absorb", True)


def test_approx_pairs_follow_the_config():
    """An inexact (plain-GELU) DensePairOp is left alone unless
    ``cle_include_approx_pairs``; then it is equalized as JAX does."""
    rng = np.random.RandomState(3)
    p = {"w1": (rng.randn(5, 8) * np.exp(rng.randn(8))).astype(np.float32),
         "b1": rng.randn(8).astype(np.float32),
         "w2": rng.randn(8, 4).astype(np.float32)}
    op = dict(w1=("w1",), b1=("b1",), w2=("w2",), exact=False)
    for include in (False, True):
        jout = jax_run_plan_ops(
            {k: jnp.asarray(v) for k, v in p.items()},
            jgraph.DFQPlan(ops=(jgraph.DensePairOp(**op),), sites=()),
            JaxDFQConfig(cle_include_approx_pairs=include))
        tout = run_plan_ops({k: _t(v) for k, v in p.items()},
                            DFQPlan(ops=(DensePairOp(**op),), sites=()),
                            DFQConfig(cle_include_approx_pairs=include))
        for k in p:
            _eq(tout[k], jout[k], k)
        assert np.array_equal(tout["w1"].numpy(), p["w1"]) != include


def test_dfq_config_fields_equal_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxDFQConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(DFQConfig)]
    assert tf == jf


# ------------------------------------------------------------ hostile_rescale
def test_hostile_rescale_matches_jax():
    """The smoke LM's exact MLP pairs rescaled by the JAX package's scales:
    each weight within 8 ulp of JAX's (the scale is exp of a normal draw
    within 4 ulp, so its relative error is a few ulp of |log s| ≤ ~7)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.weights import from_jax_numpy

    jm = jax_build_model(jax_get_config("qwen2-0.5b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    jh = jax_to_numpy(jadv.hostile_rescale(jp, jm.dfq_plan(), seed=3,
                                           decades=1.5))
    tm = build_model(get_config("qwen2-0.5b-smoke"))
    tp = from_jax_numpy(jax_to_numpy(jp), tm.cfg, device="cpu")
    th = hostile_rescale(tp, tm.dfq_plan(), seed=3, decades=1.5)
    j0 = jax_to_numpy(jp)
    changed = 0
    for name, j in jh["blocks"]["mlp"].items():
        t = th["blocks"]["mlp"][name].numpy()
        np.testing.assert_allclose(t, j, rtol=8 * F32_ULP, atol=0,
                                   err_msg=name)
        changed += not np.array_equal(j, j0["blocks"]["mlp"][name])
    assert changed >= 2


# ------------------------------------------------------- SAME-padded convs
@pytest.mark.parametrize("n", [7, 8, 16, 17, 32])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["conv", "depthwise", "1x1"])
def test_conv_same_padding_matches_lax(n, stride, kind):
    """XLA's "SAME" pads (0, 1) at n=32 (and every even n) with k=3 and
    stride 2; ``F.conv2d(padding=1)`` would pad (1, 1) and shift every
    window by one pixel. The port's ``_conv`` matches
    ``lax.conv_general_dilated`` at even and odd sizes, strides 1 and 2."""
    rng = np.random.RandomState(n * 10 + stride)
    c = 6
    k = 1 if kind == "1x1" else 3
    groups = c if kind == "depthwise" else 1
    x = rng.randn(2, n, n + 1, c).astype(np.float32)
    w = rng.randn(k, k, c // groups, 5 if groups == 1 else c).astype(np.float32)
    y = _conv(_t(x), _t(w), stride, groups).numpy()
    yj = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), stride, groups))
    assert y.shape == yj.shape
    mag = np.asarray(jax_conv(jnp.abs(jnp.asarray(x)), jnp.abs(jnp.asarray(w)),
                              stride, groups))
    taps = k * k * (c // groups)
    assert (np.abs(y - yj) <= 2 * taps * F32_ULP * mag + 1e-30).all()
    if kind == "conv" and stride == 2 and n % 2 == 0:
        shifted = torch.nn.functional.conv2d(
            _t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1), stride=2,
            padding=1).permute(0, 2, 3, 1).numpy()
        assert np.abs(shifted - yj).max() > 0.1     # the hazard is real
