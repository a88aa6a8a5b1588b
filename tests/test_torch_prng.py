"""The port's threefry drawer (``repro_torch.data.prng``) against
``jax.random``, and the default calibration it feeds.

Every word is an exact integer operation, so keys, bits and ids are held
bit for bit, and so are ``uniform``'s floats (a mantissa and one fused
multiply-add, as XLA's CPU backend contracts it). ``normal`` evaluates
XLA's float32 ``erf_inv`` in numpy float32, whose ``log1p`` and ``sqrt``
may round otherwise: within 4 ulp of ``jax.random.normal``. The CNN's
images (``synthetic_image_batch``) then have JAX's labels bit for bit and
its pixels within 1e-6 (numpy's float32 ``sin`` / ``cos`` against XLA's). The default-argument ``repro_torch.quantize`` then calibrates
on the JAX package's ids: its corrected biases are held against
``repro.quantize``'s within the bound of ``test_torch_pipeline.py``'s
Fig. 4 parity test (the E[x] difference through |ε|, plus two float32 sums
of D products in other orders), with no ``calibration=`` passed to either.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro
from _torch_port import hostile_jax_params, jax_to_numpy
from repro.data.synthetic import calibration_tokens as jax_calibration_tokens
from repro.data.synthetic import synthetic_image_batch as jax_image_batch

import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.data import calibration_tokens, prng, synthetic_image_batch
from repro_torch.quantized import QTensor
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b-smoke"
SEEDS = [0, 1, 7, 777, 2 ** 31 - 1, -5]


def _key(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.PRNGKey(seed)
    np.testing.assert_array_equal(k, _key(jk))
    for data in (0, 3, 777, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(k, data),
                                      _key(jax.random.fold_in(jk, data)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(k, num),
                                      _key(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", [(4,), (3, 5), (2, 3, 7)])
def test_random_bits_bit_equal(shape):
    jk = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        prng.random_bits(prng.PRNGKey(11), shape),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 256), (-7, 9), (0, 151936),
                                   (5, 5), (10, 3), (0, 2 ** 31 - 1)])
def test_randint_bit_equal(lo, hi):
    jk = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        prng.randint(prng.PRNGKey(3), (6, 9), lo, hi),
        np.asarray(jax.random.randint(jk, (6, 9), lo, hi)))


@pytest.mark.parametrize("seed,batch,seq,vocab", [
    (1, 2, 32, 256), (0, 4, 33, 151936), (7, 3, 17, 1000), (12, 1, 5, 131072),
    (2, 8, 64, 65536), (-1, 2, 9, 12345)])
def test_calibration_tokens_bit_equal_to_jax(seed, batch, seq, vocab):
    ids = calibration_tokens(seed, batch, seq, vocab, device="cpu")
    want = np.asarray(jax_calibration_tokens(seed, batch, seq, vocab))
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (batch, seq)
    np.testing.assert_array_equal(ids.numpy(), want)


def test_calibration_tokens_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibration_tokens(1, 2, 8, 256)


def _ulps(a, b):
    """The distance in float32 steps between same-signed values."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert (np.sign(a) == np.sign(b)).all()
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 7.5), (1e-6, 1.0),
                                   (float(np.nextafter(np.float32(-1),
                                                       np.float32(0))), 1.0),
                                   (-0.3, 0.2)])
@pytest.mark.parametrize("shape", [(5,), (64, 33)])
def test_uniform_bit_equal(lo, hi, shape):
    jk = jax.random.PRNGKey(17)
    want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
    got = prng.uniform(prng.PRNGKey(17), shape, lo, hi)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,shape", [(0, (100_000,)), (5, (3, 3, 8, 16)),
                                        (-2, (7,))])
def test_normal_within_4_ulp(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert _ulps(got, want).max() <= 4
    if got.size > 1000:
        assert (got == want).mean() > 0.9        # most draws bit-equal


def test_erf_inv_within_4_ulp_and_infinite_at_one():
    u = np.concatenate([np.linspace(-1, 1, 20001, dtype=np.float32)[1:-1],
                        np.float32([1e-30, -1e-7, 0.9999999, -0.9999999])])
    got = prng.erf_inv(u)
    assert _ulps(got, np.asarray(jax.lax.erf_inv(jnp.asarray(u)))).max() <= 4
    np.testing.assert_array_equal(prng.erf_inv(np.float32([1, -1])),
                                  np.float32([np.inf, -np.inf]))


@pytest.mark.parametrize("seed,step,batch,size,classes", [
    (0, 3, 16, 32, 8), (99, 10_000, 8, 16, 8), (1, 0, 2, 224, 1000),
    (7, 5, 4, 15, 3)])
def test_synthetic_image_batch_matches_jax(seed, step, batch, size, classes):
    got = synthetic_image_batch(seed, step, batch, size, 3, classes,
                                device="cpu")
    want = jax_image_batch(seed, step, batch, size, 3, classes)
    assert got["x"].dtype == torch.float32 and got["y"].dtype == torch.int64
    assert tuple(got["x"].shape) == (batch, size, size, 3)
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=0, atol=1e-6)


def test_synthetic_image_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_image_batch(0, 0, 2, 8, 3, 4)


def test_seed_out_of_32_bits_refused():
    with pytest.raises(ValueError, match="32 bits"):
        prng.PRNGKey(2 ** 40)


def _leaves(tree, path=()):
    if isinstance(tree, dict) and set(tree) != {"q", "scale", "mode"}:
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, QTensor):
        yield path, tree.q.numpy()
    elif isinstance(tree, dict):
        yield path, tree["q"]
    else:
        yield path, np.asarray(tree)


def test_default_quantize_matches_jax(monkeypatch):
    """``repro_torch.quantize(ARCH, params)`` and ``repro.quantize(ARCH,
    params=...)``, both with every default (dfq-int8, the synthetic
    calibration): the same calibration ids reach both models, the weights
    are bit-equal, and every corrected bias is within its bound."""
    from repro.core.bias_correction import weight_quant_error
    from repro.core.dfq import DFQConfig as JaxDFQConfig
    from repro.core.tree import get_path
    from repro.models.lm import LMModel as JaxLM

    from repro_torch.models.lm import LMModel

    seen = {}

    def spy(cls, side):
        real = cls.calibration_stats

        def calibration_stats(self, params, tokens):
            stats = real(self, params, tokens)
            seen[side] = (np.asarray(tokens), {k: np.asarray(v)
                                               for k, v in stats.items()})
            return stats
        monkeypatch.setattr(cls, "calibration_stats", calibration_stats)

    spy(JaxLM, "jax")
    spy(LMModel, "port")
    jm, jp = hostile_jax_params("qwen2-0.5b")
    jq = repro.quantize(ARCH, params=jp)
    tq = repro_torch.quantize(ARCH, from_jax_numpy(jax_to_numpy(jp),
                                                   get_config(ARCH),
                                                   device="cpu"),
                              device="cpu")
    assert tq.recipe.name == jq.recipe.name == "dfq-int8"
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    jmeans, tmeans = seen["jax"][1], seen["port"][1]
    # the equalized weights the correction read, and their ε
    steps = [s.stage for s in jq.recipe.steps]
    eq = repro.quantize(ARCH, params=jp, calibration=None,
                        recipe=steps[:steps.index("bias_correct")]).params
    spec = JaxDFQConfig().weight_spec
    biases = {s.b: s for s in jm.dfq_plan().sites}
    jl, tl = dict(_leaves(jax_to_numpy(jq.params))), dict(_leaves(tq.params))
    assert sorted(jl) == sorted(tl)
    for path, t in tl.items():
        j = jl[path]
        if path not in biases:
            np.testing.assert_array_equal(t, j, err_msg=str(path))
            continue
        site = biases[path]
        eps = np.abs(np.asarray(weight_quant_error(get_path(eq, site.w),
                                                   spec), np.float64))
        e_j = np.asarray(jmeans[site.stat_key], np.float64)
        delta = np.abs(tmeans[site.stat_key] - e_j)
        D = eps.shape[-2]
        bound = (np.einsum("...i,...io->...o", delta, eps)
                 + 2 * D * 2.0 ** -24 * np.einsum("...i,...io->...o",
                                                  np.abs(e_j), eps))
        bound = bound * (1 + 2.0 ** -20) + np.spacing(
            np.maximum(np.abs(j), np.abs(t)))
        if path == ("blocks", "attn", "bo"):
            bound = bound + 2e-6      # absorption's matrix-product rounding
        assert (np.abs(t - j) <= bound).all(), path
