"""The port's bias correction (``repro_torch.core.bias_correction``,
``clipped_normal``, the correction half of ``core.dfq``) and the model's
calibration statistics against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its ``repro_torch`` counterpart. Tolerances:

  * ``clipped_normal_mean`` / ``_var``, ``relu_normal_mean``,
    ``gaussian_expect`` and ``expected_input_analytic`` (all five
    activations): rtol 1e-5, atol 1e-6 in float32 — φ, Φ, tanh and the
    quadrature's 64-term sum are evaluated by other float32 routines on
    each side;
  * ``weight_quant_error`` and ``quantize_weights``: bit-equal — min, max,
    one division, round and clip, each correctly rounded;
  * ``bias_correction_dense`` / ``_conv`` and ``bias_correct`` on the same
    E[x]: within the rounding bound of the sum over the input channels,
    ``2·D·2⁻²⁴·(|e_x| @ |ε|)`` (two float32 sums of the same D products in
    other orders) plus one ulp of |b| for the subtraction;
  * ``LMModel.calibration_stats`` at smoke size on the JAX tokens: every
    key, ``final_h`` included, within ``STAT_TOL · max |E[x]|`` of the key,
    STAT_TOL = 2⁻¹⁶ — the forward's float32 sums run in other orders
    (measured max 5.1e-7 relative, ``down_in``).

The JAX module tests' own assertions (``test_core_bias.py``,
``test_core_clipped_normal.py``) are re-stated on the port alone, with
torch's generator for the Monte Carlo draws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_port import hostile_jax_params, jax_to_numpy
from repro.core import bias_correction as jbc
from repro.core import clipped_normal as jcn
from repro.core import dfq as jdfq
from repro.core.quantizer import QuantSpec as JaxQuantSpec
from repro.core.quantizer import fake_quant as jax_fake_quant
from repro.data import calibration_tokens as jax_calibration_tokens

from repro_torch import get_config
from repro_torch.core import (
    DFQConfig,
    QuantSpec,
    bias_correct,
    bias_correction_conv,
    bias_correction_dense,
    clipped_normal_mean,
    clipped_normal_var,
    empirical_bias_correction_sequential,
    expected_input_analytic,
    fake_quant,
    gaussian_expect,
    output_bias_error,
    quantize_weights,
    relu_normal_mean,
    weight_quant_error,
    weight_quant_snr,
)
from repro_torch.core.tree import get_path
from repro_torch.data import calibration_tokens
from repro_torch.models import build_model
from repro_torch.weights import from_jax_numpy

RTOL, ATOL = 1e-5, 1e-6
STAT_TOL = 2.0 ** -16
ARCH = "qwen2-0.5b"


def _np(seed, *shape, scale=1.0, positive=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return np.abs(a) + 0.1 if positive else a


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(torch_out, jax_out, what=""):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _sum_bound(e_x, eps, b=None):
    """2·D·2⁻²⁴·(|e_x| @ |ε|) + one ulp of |b|: two float32 sums of the
    same D products in other orders, then the subtraction from b."""
    e_x, eps = np.abs(np.asarray(e_x, np.float64)), np.abs(np.asarray(eps))
    D = eps.shape[-2]
    bound = 2 * D * 2.0 ** -24 * np.einsum("...i,...io->...o", e_x, eps)
    if b is not None:
        bound = bound + np.spacing(np.abs(np.asarray(b, np.float32)))
    return bound


# ----------------------------------------------------------- clipped normal

CLIPS = [(0.0, None), (0.0, 6.0), (-1.5, 0.5), (-0.3, 4.0)]


@pytest.mark.parametrize("a,b", CLIPS, ids=[f"a{a}_b{b}" for a, b in CLIPS])
def test_clipped_normal_moments_match_jax(a, b):
    mu, sigma = _np(0, 64, scale=2.0), _np(1, 64, positive=True)
    _close(clipped_normal_mean(_t(mu), _t(sigma), a, b),
           jcn.clipped_normal_mean(jnp.asarray(mu), jnp.asarray(sigma), a, b),
           "mean")
    _close(clipped_normal_var(_t(mu), _t(sigma), a, b),
           jcn.clipped_normal_var(jnp.asarray(mu), jnp.asarray(sigma), a, b),
           "var")


def test_relu_normal_mean_matches_jax():
    beta, gamma = _np(2, 50, scale=2.0), _np(3, 50)        # gamma of any sign
    _close(relu_normal_mean(_t(beta), _t(gamma)),
           jcn.relu_normal_mean(jnp.asarray(beta), jnp.asarray(gamma)))


@pytest.mark.parametrize("fn", ["gelu", "silu"])
def test_gaussian_expect_matches_jax(fn):
    mu, sigma = _np(4, 3, 17, scale=1.5), _np(5, 3, 17, positive=True)
    tf = {"gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
          "silu": torch.nn.functional.silu}[fn]
    jf = {"gelu": jax.nn.gelu, "silu": jax.nn.silu}[fn]
    _close(gaussian_expect(tf, _t(mu), _t(sigma)),
           jcn.gaussian_expect(jf, jnp.asarray(mu), jnp.asarray(sigma)))


@pytest.mark.parametrize("act", ["identity", "relu", "relu6", "gelu", "silu"])
def test_expected_input_analytic_matches_jax(act):
    """All five activations; GELU is JAX's default tanh form."""
    beta, gamma = _np(6, 40, scale=2.0), _np(7, 40)
    _close(expected_input_analytic(_t(beta), _t(gamma), act),
           jbc.expected_input_analytic(jnp.asarray(beta), jnp.asarray(gamma),
                                       act), act)
    with pytest.raises(ValueError, match="unknown activation"):
        expected_input_analytic(_t(beta), _t(gamma), "tanh")


def _mc(mu, sigma, a, b, n=400000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = mu + sigma * torch.randn(n, generator=gen, dtype=torch.float64)
    y = torch.clamp(x, a, b if b is not None else float("inf"))
    return float(y.mean()), float(y.var(correction=0))


@pytest.mark.parametrize("mu,sigma,a,width", [(0.3, 1.0, 0.0, 6.0),
                                              (-1.2, 0.4, -2.0, 1.5),
                                              (2.5, 2.0, -0.5, 3.0),
                                              (0.0, 0.1, 0.2, 0.5)])
def test_clipped_moments_match_monte_carlo(mu, sigma, a, width):
    """``test_core_clipped_normal.py``'s check on the port: eq. 38 and 44
    against 400k draws."""
    b = a + width
    m = float(clipped_normal_mean(torch.tensor(mu), torch.tensor(sigma), a, b))
    v = float(clipped_normal_var(torch.tensor(mu), torch.tensor(sigma), a, b))
    m_mc, v_mc = _mc(mu, sigma, a, b)
    assert abs(m - m_mc) < 0.02 * max(1.0, abs(m_mc))
    assert abs(v - v_mc) < 0.05 * max(0.05, v_mc)


def test_clipped_normal_limits():
    """The relu case equals eq. 19; the far-left, far-right and wide-interval
    limits; the variance never negative."""
    mu, sigma = torch.linspace(-3, 3, 13), torch.linspace(0.1, 3, 13)
    assert float((relu_normal_mean(mu, sigma)
                  - clipped_normal_mean(mu, sigma, 0.0, None)).abs().max()) < 1e-5
    one = torch.tensor(1.0)
    assert abs(float(clipped_normal_mean(torch.tensor(-100.0), one, 0.0, 6.0))) < 1e-4
    assert abs(float(clipped_normal_mean(torch.tensor(100.0), one, 0.0, 6.0)) - 6) < 1e-4
    assert abs(float(clipped_normal_mean(torch.tensor(0.3), one, -50.0, 50.0)) - 0.3) < 1e-4
    assert abs(float(clipped_normal_var(torch.tensor(0.3), one, -50.0, 50.0)) - 1) < 1e-3
    assert float(clipped_normal_var(torch.tensor(50.0), torch.tensor(0.1), 0.0, 6.0)) >= 0


# ---------------------------------------------------------- bias correction

SPECS = [(8, False, None), (4, True, None), (6, False, -1), (8, True, -1)]


@pytest.mark.parametrize("bits,sym,axis", SPECS,
                         ids=[f"b{b}_{'sym' if s else 'asym'}_{'pc' if a else 'pt'}"
                              for b, s, a in SPECS])
def test_weight_quant_error_bit_equal(bits, sym, axis):
    w = _np(8, 3, 48, 24) * np.exp(_np(9, 24))
    got = weight_quant_error(_t(w), QuantSpec(bits, sym, axis))
    want = jbc.weight_quant_error(jnp.asarray(w), JaxQuantSpec(bits, sym, axis))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the residual of the quantizer: w + ε is the fake-quantized w
    np.testing.assert_allclose((_t(w) + got).numpy(),
                               fake_quant(_t(w), QuantSpec(bits, sym, axis)).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_bias_correction_dense_within_the_sum_bound(stacked, with_bias):
    lead = (3,) if stacked else ()
    w = _np(10, *lead, 96, 40) * np.exp(_np(11, 40))
    e_x = _np(12, *lead, 96, positive=True)
    b = _np(13, *lead, 40) if with_bias else None
    spec = QuantSpec(bits=4)
    got = bias_correction_dense(_t(w), None if b is None else _t(b), _t(e_x),
                                spec)
    want = jbc.bias_correction_dense(jnp.asarray(w),
                                     None if b is None else jnp.asarray(b),
                                     jnp.asarray(e_x), JaxQuantSpec(bits=4))
    eps = np.asarray(jbc.weight_quant_error(jnp.asarray(w), JaxQuantSpec(bits=4)))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert (diff <= _sum_bound(e_x, eps, b)).all(), diff.max()


def test_bias_correction_dense_widens_a_bf16_mean():
    """A bf16 E[x] (the full-width calibration forward's dtype) is widened
    to ε's float32 before the product, as ``jnp.einsum`` promotes it."""
    w, e_x = _np(14, 64, 32), _np(15, 64, positive=True)
    e_bf = torch.from_numpy(e_x).to(torch.bfloat16)
    got = bias_correction_dense(_t(w), None, e_bf, QuantSpec())
    assert got.dtype == torch.float32
    want = jbc.bias_correction_dense(
        jnp.asarray(w), None, jnp.asarray(e_bf.float().numpy()).astype(jnp.bfloat16),
        JaxQuantSpec())
    eps = np.asarray(jbc.weight_quant_error(jnp.asarray(w), JaxQuantSpec()))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert (diff <= _sum_bound(e_bf.float().numpy(), eps)).all()


@pytest.mark.parametrize("depthwise", [False, True])
def test_bias_correction_conv_within_the_sum_bound(depthwise):
    cin = 1 if depthwise else 8
    cout = 8 if depthwise else 4
    w = _np(16, 3, 3, cin, cout)
    e_x = _np(17, 8 if depthwise else cin, positive=True)
    b = _np(18, cout)
    spec = QuantSpec(bits=6)
    got = bias_correction_conv(_t(w), _t(b), _t(e_x), spec, depthwise=depthwise)
    want = jbc.bias_correction_conv(jnp.asarray(w), jnp.asarray(b),
                                    jnp.asarray(e_x), JaxQuantSpec(bits=6),
                                    depthwise=depthwise)
    eps = np.abs(np.asarray(jbc.weight_quant_error(jnp.asarray(w),
                                                   JaxQuantSpec(bits=6))))
    # the sum over the n = 9·cin products (depthwise: the 9 taps, then one
    # product with E[x], one more rounding), in other orders on each side
    n = 9 * cin
    bound = 2 * n * 2.0 ** -24 * np.abs(e_x) * eps[..., 0, :].sum((0, 1)) \
        if depthwise else 2 * n * 2.0 ** -24 * np.einsum("i,hwio->o",
                                                         np.abs(e_x), eps)
    bound = bound * (1 + 2.0 ** -23) + np.spacing(np.abs(b))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert (diff <= bound).all(), diff.max()
    # appendix B: the correction is ε's spatial sum against E[x]
    direct = -(torch.einsum("i,hwio->o", _t(e_x), weight_quant_error(_t(w), spec))
               if not depthwise else _t(e_x) * weight_quant_error(_t(w), spec)
               [..., 0, :].sum((0, 1)))
    np.testing.assert_allclose((got - _t(b)).numpy(), direct.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_bias_correction_zeroes_output_mean_shift():
    """Paper Fig. 3 / eq. 16-17 (``test_core_bias.py``'s check on the
    port): after the correction E[ỹ − y] ≈ 0 per channel."""
    gen = torch.Generator().manual_seed(0)
    d, out, n = 32, 16, 4096
    w = torch.randn((d, out), generator=gen) * torch.exp(
        torch.randn((out,), generator=gen) * 1.5)
    b = torch.zeros(out)
    spec = QuantSpec(bits=4)
    x = torch.randn((n, d), generator=gen).abs() + 0.5
    w_q = fake_quant(w, spec)
    before = output_bias_error(x @ w + b, x @ w_q + b)
    b_corr = bias_correction_dense(w, b, x.mean(0), spec)
    after = output_bias_error(x @ w + b, x @ w_q + b_corr)
    assert float(after.abs().max()) < 0.05 * float(before.abs().max())


def test_output_bias_error_matches_jax():
    y, yq = _np(19, 4, 6, 10), _np(20, 4, 6, 10)
    for axis in (-1, 1):
        _close(output_bias_error(_t(y), _t(yq), axis),
               jbc.output_bias_error(jnp.asarray(y), jnp.asarray(yq), axis))


def test_empirical_sequential_bc_matches_jax_and_drives_residual_to_zero():
    """Appendix D on a ReLU chain: the port's corrected biases against the
    JAX package's, and every layer's residual mean error below 1e-3."""
    dims, n = [16, 32, 24, 8], 2048
    ws = [_np(21 + i, dims[i], dims[i + 1]) * np.exp(_np(31 + i, dims[i + 1]))
          for i in range(3)]
    x0 = np.abs(_np(41, n, dims[0]))

    def t_layer(i, x, w, b):
        return (x if i == 0 else torch.relu(x)) @ w + b

    def j_layer(i, x, w, b):
        return (x if i == 0 else jax.nn.relu(x)) @ w + b

    got = empirical_bias_correction_sequential(
        t_layer, [_t(w) for w in ws], [torch.zeros(d) for d in dims[1:]],
        _t(x0), lambda w: fake_quant(w, QuantSpec(bits=4)))
    want = jbc.empirical_bias_correction_sequential(
        j_layer, [jnp.asarray(w) for w in ws], [jnp.zeros(d) for d in dims[1:]],
        jnp.asarray(x0), lambda w: jax_fake_quant(w, JaxQuantSpec(bits=4)))
    for r in got.residual_bias:
        assert float(r.abs().max()) < 1e-3
    for bt, bj in zip(got.biases, want.biases):
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------ model-level parity

@pytest.fixture(scope="module")
def hostile():
    jm, jp = hostile_jax_params(ARCH)
    cfg = get_config(f"{ARCH}-smoke")
    tm = build_model(cfg)
    toks = np.array(jax_calibration_tokens(1, 2, 32, cfg.vocab_size))
    return jm, jp, tm, from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu"), toks


def test_calibration_stats_match_jax(hostile):
    """Every stat key, ``final_h`` included, [L, D] per site key, on the
    same (JAX) tokens."""
    jm, jp, tm, tp, toks = hostile
    want = jm.calibration_stats(jp, jnp.asarray(toks))
    got = tm.calibration_stats(tp, torch.from_numpy(toks).long())
    assert sorted(got) == sorted(want) == ["attn_in", "down_in", "final_h",
                                           "mlp_in", "o_in"]
    for k, j in want.items():
        j = np.asarray(j)
        assert got[k].shape == j.shape and got[k].dtype == torch.float32, k
        tol = STAT_TOL * np.abs(j).max()
        assert np.abs(got[k].numpy() - j).max() <= tol, k
    # apply with and without capture: the same logits
    logits, _ = tm.apply(tp, torch.from_numpy(toks).long(), capture=True)
    assert torch.equal(logits, tm.apply(tp, torch.from_numpy(toks).long()))


def test_calibration_stats_keep_the_compute_dtype():
    """A bf16 model records bf16 means, as the JAX scan does."""
    import dataclasses

    cfg = dataclasses.replace(get_config(f"{ARCH}-smoke"), dtype="bfloat16")
    m = build_model(cfg)
    stats = m.calibration_stats(m.init(0, device="cpu"),
                                calibration_tokens(1, 2, 8, cfg.vocab_size,
                                                   device="cpu"))
    assert all(v.dtype == torch.bfloat16 for v in stats.values())
    assert stats["down_in"].shape == (cfg.n_layers, cfg.d_ff)
    assert stats["final_h"].shape == (cfg.d_model,)


def test_calibration_tokens_seeded_and_in_range():
    a = calibration_tokens(1, 2, 32, 256, device="cpu")
    assert a.shape == (2, 32) and a.dtype == torch.int64
    assert torch.equal(a, calibration_tokens(1, 2, 32, 256, device="cpu"))
    assert not torch.equal(a, calibration_tokens(2, 2, 32, 256, device="cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 256


@pytest.mark.parametrize("bits,per_channel", [(8, False), (4, False), (8, True)])
def test_quantize_weights_bit_equal(hostile, bits, per_channel):
    jm, jp, tm, tp, _ = hostile
    cfg = DFQConfig(weight_bits=bits, per_channel=per_channel)
    jcfg = jdfq.DFQConfig(weight_bits=bits, per_channel=per_channel)
    got = quantize_weights(tp, tm.dfq_plan(), cfg)
    want = jdfq.quantize_weights(jp, jm.dfq_plan(), jcfg)
    for site in tm.dfq_plan().sites:
        np.testing.assert_array_equal(get_path(got, site.w).numpy(),
                                      np.asarray(get_path(want, site.w)),
                                      err_msg=site.name)
    snr = weight_quant_snr(tp, got, tm.dfq_plan())
    jsnr = jdfq.weight_quant_snr(jp, want, jm.dfq_plan())
    assert sorted(snr) == sorted(jsnr)
    assert all(abs(snr[k] - jsnr[k]) < 1e-4 for k in snr)


def test_bias_correct_on_the_same_means_within_the_sum_bound(hostile):
    """``core.dfq.bias_correct`` on JAX's own E[x]: every site's bias,
    created where the model had none (bg, bu, bd's correction alone), within
    the sum bound of its site."""
    jm, jp, tm, tp, toks = hostile
    means = jm.calibration_stats(jp, jnp.asarray(toks))
    cfg, jcfg = DFQConfig(), jdfq.DFQConfig()
    got = bias_correct(tp, tm.dfq_plan(), cfg,
                       {k: _t(v) for k, v in means.items()})
    want = jdfq.bias_correct(jp, jm.dfq_plan(), jcfg, means)
    assert "bg" not in tp["blocks"]["mlp"] and "bg" in got["blocks"]["mlp"]
    for site in tm.dfq_plan().sites:
        e_x = np.asarray(means[site.stat_key])
        eps = np.asarray(jbc.weight_quant_error(get_path(jp, site.w),
                                                jcfg.weight_spec))
        b_old = (np.asarray(get_path(jp, site.b))
                 if site.b[-1] in jp["blocks"][site.b[1]] else None)
        diff = np.abs(get_path(got, site.b).numpy()
                      - np.asarray(get_path(want, site.b)))
        assert (diff <= _sum_bound(e_x, eps, b_old)).all(), site.name
