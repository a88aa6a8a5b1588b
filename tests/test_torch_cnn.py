"""The port's MobileNetV2-style CNN (``repro_torch.models.cnn``) against
``repro.models.cnn`` on a tiny configuration (3 blocks, width 8, 16×16
images), on the CPU.

The JAX params (its init with random BatchNorm statistics) and each JAX
transform's output are carried across through numpy, so every transform is
checked on its own inputs. Tolerances, each from the arithmetic it covers:

* ``init``: JAX's keys, normals within 4 ulp, divided by √fan — 5 ulp;
* ``fold``, ``equalize``, ``quantize_weights``: elementwise float32 (the
  square roots correctly rounded): bit-equal;
* ``absorb_high_bias``: the shifted biases are sums of 9·C products —
  ``n · 2⁻²³ · Σ|c·w|``; every other leaf bit-equal;
* ``bias_correct_analytic``: E[x] through ``erf`` / ``exp`` and a sum of
  9·C products: within 1e-6 of the corrected bias's magnitude plus the
  summation bound;
* forwards (``apply_train``, ``apply_folded``, the gradients): float32
  convolutions summing in other orders, through BatchNorm's division by
  the batch std — within 2e-5 of the output's largest magnitude;
* activation fake-quantization: a value within rounding of a grid step's
  midpoint may land one step (≤ 6/255) away on one side; averaged over the
  pool's pixels that moves a logit far less than 1e-3 of its magnitude, so
  those logits are held within 1e-3 of their largest magnitude, and the
  top-1 class agrees on 90 % of the images.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from benchmarks._cnn_pipeline import adversarial_rescale
from repro.configs.mobilenet_v2 import CONFIG as JAX_MOBILENET_V2
from repro.core import QuantSpec as JaxQuantSpec
from repro.core import fake_quant_with_qparams as jax_fqp
from repro.core import qparams_from_range as jax_qparams_from_range
from repro.core import cle as jcle
from repro.models import cnn as jcnn

from repro_torch.configs.mobilenet_v2 import CONFIG as MOBILENET_V2
from repro_torch.core import (
    QuantSpec,
    equalize_conv_chain,
    fake_quant_with_qparams,
    qparams_from_range,
)
from repro_torch.core.cle import ConvLayer
from repro_torch.models import CNNConfig, MobileNetCNN
from repro_torch.weights import cnn_from_jax_numpy

TINY = dict(name="mobilenet_v2-tiny", in_channels=3, num_classes=5, width=8,
            blocks=((1, 8, 1), (3, 12, 2), (3, 12, 1)), img_size=16,
            act_clip=6.0)
F32_ULP = 2.0 ** -23
FWD_TOL = 2e-5
ACT_QUANT_TOL = 1e-3


@pytest.fixture(scope="module")
def models():
    return jcnn.MobileNetCNN(jcnn.CNNConfig(**TINY)), MobileNetCNN(CNNConfig(**TINY))


def _random_bn(params, seed):
    """JAX params with every BatchNorm's γ, β, mean and var drawn at
    random, so that folding and absorption do real work."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, params)

    def bn(node):
        c = node["gamma"].shape[0]
        return {"gamma": np.exp(rng.randn(c) * 0.5).astype(np.float32),
                "beta": rng.randn(c).astype(np.float32),
                "mean": (rng.randn(c) * 0.3).astype(np.float32),
                "var": np.exp(rng.randn(c) * 0.5).astype(np.float32)}

    params["stem"]["bn"] = bn(params["stem"]["bn"])
    for blk in params["blocks"]:
        for k in ("expand", "dw", "project"):
            blk[k]["bn"] = bn(blk[k]["bn"])
    return params


@pytest.fixture(scope="module")
def jax_params(models):
    jm, _ = models
    return _random_bn(jm.init(jax.random.PRNGKey(0)), 1)


def _images(seed, batch=8):
    rng = np.random.RandomState(seed)
    return rng.randn(batch, 16, 16, 3).astype(np.float32)


def _leaves(tree, path=(), tensors=False):
    """(path, numpy array) of a JAX or port tree (the port's tensors as
    they are with ``tensors``): dicts by sorted key, lists, FoldedLayer
    fields; ``stride`` ints as they are."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,), tensors)
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), path + (k,), tensors)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,), tensors)
    elif isinstance(tree, int) or (tensors and torch.is_tensor(tree)):
        yield path, tree
    else:
        yield path, (tree.detach().numpy() if torch.is_tensor(tree)
                     else np.asarray(tree))


def _port(tree):
    return cnn_from_jax_numpy(jax.device_get(tree), CNNConfig(**TINY),
                              device="cpu")


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_mobilenet_v2_config_equals_jax():
    import dataclasses

    assert dataclasses.asdict(MOBILENET_V2) == dataclasses.asdict(
        JAX_MOBILENET_V2)
    assert [f.name for f in dataclasses.fields(CNNConfig)] == [
        f.name for f in dataclasses.fields(jcnn.CNNConfig)]


@pytest.mark.parametrize("seed", [0, 3])
def test_init_matches_jax(models, seed):
    jm, tm = models
    want = dict(_leaves(jm.init(jax.random.PRNGKey(seed))))
    got = dict(_leaves(tm.init(seed, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == np.float32, path
        if path[-1] == "w":
            assert (np.sign(t) == np.sign(want[path])).all()
            assert _ulps(t, want[path]).max() <= 5, path
        else:
            np.testing.assert_array_equal(t, want[path], err_msg=str(path))


def test_init_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models[1].init(0)


def test_cnn_from_jax_numpy_checks_the_config(jax_params):
    tree = jax.device_get(jax_params)
    for bad in (dict(TINY, width=16), dict(TINY, blocks=TINY["blocks"][:2]),
                dict(TINY, num_classes=10)):
        with pytest.raises(ValueError, match="mobilenet_v2-tiny"):
            cnn_from_jax_numpy(tree, CNNConfig(**bad), device="cpu")


def _close(t, j, tol=FWD_TOL, what=""):
    t, j = np.asarray(t), np.asarray(j)
    err = np.abs(t - j).max()
    scale = np.abs(j).max()
    print(f"{what}: max |diff| {err:.3g} of max |ref| {scale:.3g}")
    assert err <= tol * scale + 1e-30, what


def test_apply_train_matches_jax(models, jax_params):
    """Logits and the updated running statistics: the batch variance is
    the population variance, the update 0.9·old + 0.1·batch."""
    jm, tm = models
    x = _images(0)
    jl, jnew = jm.apply_train(jax.tree.map(jnp.asarray, jax_params),
                              jnp.asarray(x))
    tl, tnew = tm.apply_train(_port(jax_params), torch.from_numpy(x))
    _close(tl.detach(), jl, what="logits")
    want = dict(_leaves(jnew))
    for path, t in _leaves(tnew):
        _close(t, want[path], what=str(path))
    # eval-mode BN reads the running statistics instead
    jl, _ = jm.apply_train(jax.tree.map(jnp.asarray, jax_params),
                           jnp.asarray(x), train_bn=False)
    tl, _ = tm.apply_train(_port(jax_params), torch.from_numpy(x),
                           train_bn=False)
    _close(tl, jl, what="eval logits")


def test_train_step_matches_jax(models, jax_params):
    """One step's loss and gradients against ``jax.value_and_grad``. The
    loss does not read the running statistics: JAX's gradient there is 0,
    and autograd's is unset — the port's step uses zeros."""
    jm, tm = models
    rng = np.random.RandomState(2)
    batch = {"x": _images(2), "y": rng.randint(0, 5, 8)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, jax_params))
    params = _port(jax_params)
    paths, leaves = zip(*_leaves(params, tensors=True))
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tm.loss(params, {"x": torch.from_numpy(batch["x"]),
                               "y": torch.from_numpy(batch["y"])})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = dict(_leaves(jgrads))
    # a gradient that is 0 in exact arithmetic (a β whose shift the next
    # BatchNorm's batch mean removes) is rounding noise on both sides:
    # each leaf within 1e-4 of its own largest magnitude or 1e-6 of the
    # whole gradient's
    top = max(np.abs(g).max() for g in want.values())
    for path, g in zip(paths, grads):
        if path[-1] in ("mean", "var"):
            assert g is None and not want[path].any(), path
            continue
        err = np.abs(g.numpy() - want[path]).max()
        assert err <= 1e-4 * np.abs(want[path]).max() + 1e-6 * top, path


@pytest.fixture(scope="module")
def jax_stages(models, jax_params):
    """The JAX flow's trees, stage by stage, on a hostile rescale of the
    folded model (benchmarks' ``adversarial_rescale``)."""
    jm, _ = models
    folded = jm.fold(jax.tree.map(jnp.asarray, jax_params))
    hostile = adversarial_rescale(folded, seed=0, decades=1.5)
    eq = jm.equalize(hostile)
    ab = jm.absorb_high_bias(eq)
    spec = JaxQuantSpec(bits=8)
    q = jm.quantize_weights(ab, spec)
    return {"params": jax_params, "folded": folded, "hostile": hostile,
            "equalized": eq, "absorbed": ab, "quantized": q,
            "corrected": jm.bias_correct_analytic(ab, q, spec),
            "corrected6": jm.bias_correct_analytic(ab, q, spec, act_clip=6.0)}


def _check_bit_equal(got, want):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t, want[path], err_msg=str(path))


def test_fold_bit_equal(models, jax_stages):
    _check_bit_equal(models[1].fold(_port(jax_stages["params"])),
                     jax_stages["folded"])


def test_equalize_bit_equal(models, jax_stages):
    _check_bit_equal(models[1].equalize(_port(jax_stages["hostile"])),
                     jax_stages["equalized"])


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_weights_bit_equal(models, jax_stages, per_channel):
    jm, tm = models
    axis = -1 if per_channel else None
    want = jm.quantize_weights(jax_stages["absorbed"],
                               JaxQuantSpec(bits=8, per_channel_axis=axis))
    got = tm.quantize_weights(_port(jax_stages["absorbed"]),
                              QuantSpec(bits=8, per_channel_axis=axis))
    _check_bit_equal(got, want)


def test_equalize_runs_jax_passes(models, jax_stages):
    """Each block's chain runs as many passes as JAX's on the hostile
    model (and more than one)."""
    from test_torch_cnn_core import _jax_passes

    hostile = jax_stages["hostile"]
    port = _port(hostile)
    for i in range(len(hostile["blocks"])):
        kinds = (("expand", "conv"), ("dw", "depthwise"), ("project", "conv"))
        jl = [jcle.ConvLayer(jnp.asarray(hostile["blocks"][i][k].w),
                             jnp.asarray(hostile["blocks"][i][k].b), kind)
              for k, kind in kinds]
        tl = [ConvLayer(port["blocks"][i][k].w, port["blocks"][i][k].b, kind)
              for k, kind in kinds]
        passes = equalize_conv_chain(tl, 20).passes
        assert passes == _jax_passes(jl, 20) > 1, i


def test_absorb_high_bias_matches_jax(models, jax_stages):
    got = dict(_leaves(models[1].absorb_high_bias(
        _port(jax_stages["equalized"]))))
    want = dict(_leaves(jax_stages["absorbed"]))
    eq = jax_stages["equalized"]
    assert sorted(got) == sorted(want)
    shifted = 0
    for path, t in got.items():
        if path[0] == "blocks" and path[2:] in (("dw", "b"),
                                                ("project", "b")):
            blk = eq["blocks"][path[1]]
            src = "expand" if path[2] == "dw" else "dw"
            c = np.maximum(0, np.asarray(blk[src].act_mean)
                           - 3 * np.asarray(blk[src].act_std))
            w2 = np.abs(np.asarray(blk[path[2]].w))
            terms = (np.abs(c) * w2[:, :, 0, :].sum(axis=(0, 1))
                     if path[2] == "dw" else np.einsum("i,hwio->o", c, w2))
            n = 9 if path[2] == "dw" else w2.shape[2]
            bound = (n * F32_ULP * terms
                     + F32_ULP * (np.abs(np.asarray(blk[path[2]].b)) + terms))
            assert (np.abs(t - want[path]) <= bound + 1e-30).all(), path
            shifted += int((c > 0).any())
        else:
            np.testing.assert_array_equal(t, want[path], err_msg=str(path))
    assert shifted >= 2                # the hostile model needs absorption


@pytest.mark.parametrize("act_clip", [None, 6.0])
def test_bias_correct_analytic_matches_jax(models, jax_stages, act_clip):
    jm, tm = models
    key = "corrected6" if act_clip else "corrected"
    got = dict(_leaves(tm.bias_correct_analytic(
        _port(jax_stages["absorbed"]), _port(jax_stages["quantized"]),
        QuantSpec(bits=8), act_clip=act_clip)))
    want = dict(_leaves(jax_stages[key]))
    q = dict(_leaves(jax_stages["quantized"]))
    moved = 0
    for path, t in got.items():
        if path[-1] == "b" and path[0] == "blocks":
            _close(t, want[path], tol=1e-6, what=str(path))
            moved += int(not np.array_equal(want[path], q[path]))
        else:
            np.testing.assert_array_equal(t, want[path], err_msg=str(path))
    assert moved == 3 * len(TINY["blocks"])


def test_transforms_leave_their_inputs_unchanged(models, jax_stages):
    """Every transform returns a new tree: its input's leaves and structure
    are as they were (JAX deep-copies; one in-place write would corrupt
    every later use of a shared tree)."""
    _, tm = models
    spec = QuantSpec(bits=8)
    params = _port(jax_stages["params"])
    hostile = _port(jax_stages["hostile"])
    q = tm.quantize_weights(hostile, spec)

    def snapshot(tree):
        return [(p, np.array(a, copy=True)) for p, a in _leaves(tree)]

    calls = [("apply_train", lambda: tm.apply_train(
                 params, torch.from_numpy(_images(1))), params),
             ("fold", lambda: tm.fold(params), params),
             ("equalize", lambda: tm.equalize(hostile), hostile),
             ("absorb_high_bias", lambda: tm.absorb_high_bias(hostile),
              hostile),
             ("quantize_weights", lambda: tm.quantize_weights(hostile, spec),
              hostile),
             ("bias_correct_analytic",
              lambda: tm.bias_correct_analytic(hostile, q, spec), q)]
    for name, call, tree in calls:
        before = snapshot(tree)
        out = call()
        assert out is not tree
        after = snapshot(tree)
        assert [p for p, _ in before] == [p for p, _ in after], name
        for (p, a), (_, b) in zip(before, after):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {p}")


def _act_quants(act_clip):
    """benchmarks' eval_accuracy activation quantizer (8 bits, ranges
    max(0, min(β − 6γ)) .. max(β + 6γ), capped at the clip), per package."""
    def jax_q(h, name, mean, std):
        lo = jnp.maximum(jnp.minimum(jnp.min(mean - 6.0 * std), 0.0), 0.0)
        hi = jnp.max(mean + 6.0 * std)
        if act_clip is not None:
            hi = jnp.minimum(hi, act_clip)
        return jax_fqp(h, jax_qparams_from_range(lo, hi, JaxQuantSpec(bits=8)))

    def port_q(h, name, mean, std):
        lo = torch.clamp_min(torch.clamp_max(torch.min(mean - 6.0 * std), 0.0),
                             0.0)
        hi = torch.max(mean + 6.0 * std)
        if act_clip is not None:
            hi = torch.clamp_max(hi, act_clip)
        return fake_quant_with_qparams(h, qparams_from_range(
            lo, hi, QuantSpec(bits=8)))

    return jax_q, port_q


@pytest.mark.parametrize("stage", ["folded", "hostile", "corrected"])
@pytest.mark.parametrize("act_clip", [None, 6.0])
@pytest.mark.parametrize("act_quant", [False, True])
def test_apply_folded_matches_jax(models, jax_stages, stage, act_clip,
                                  act_quant):
    jm, tm = models
    jq, tq = _act_quants(act_clip) if act_quant else (None, None)
    x = _images(3, batch=16)
    want = np.asarray(jm.apply_folded(jax_stages[stage], jnp.asarray(x),
                                      act_clip=act_clip, act_quant=jq))
    got = tm.apply_folded(_port(jax_stages[stage]), torch.from_numpy(x),
                          act_clip=act_clip, act_quant=tq).numpy()
    _close(got, want, tol=ACT_QUANT_TOL if act_quant else FWD_TOL,
           what=f"{stage} logits")
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_the_paper_flow_matches_jax(models, jax_params):
    """The slice as a whole: the carried-across JAX params through the
    port's fold, the hostile rescale (JAX's scales, carried across), CLE,
    absorption, 8-bit weights and analytic correction, evaluated with 8-bit
    activations — against the JAX flow on the same images: the logits
    within the activation-quantization tolerance, the same top-1 on at
    least 90 % of them; and CLE recovers int8 from the hostile collapse on
    both sides alike."""
    jm, tm = models
    spec, jspec = QuantSpec(bits=8), JaxQuantSpec(bits=8)
    jq, tq = _act_quants(None)
    x = _images(4, batch=32)

    folded = tm.fold(_port(jax_params))
    # the hostile rescale's scales are JAX's draws: carry them across as
    # the ratio of the JAX trees' weights
    jf = jm.fold(jax.tree.map(jnp.asarray, jax_params))
    jh = adversarial_rescale(jf, seed=0, decades=1.5)
    hostile = _port(jh)
    for i, blk in enumerate(folded["blocks"]):
        for k in ("expand", "dw", "project"):
            np.testing.assert_array_equal(
                blk[k].w.numpy(), np.asarray(jf["blocks"][i][k].w))
    eq = tm.absorb_high_bias(tm.equalize(hostile))
    corrected = tm.bias_correct_analytic(eq, tm.quantize_weights(eq, spec),
                                         spec)
    got = tm.apply_folded(corrected, torch.from_numpy(x), act_quant=tq)

    jeq = jm.absorb_high_bias(jm.equalize(jh))
    jc = jm.bias_correct_analytic(jeq, jm.quantize_weights(jeq, jspec), jspec)
    want = np.asarray(jm.apply_folded(jc, jnp.asarray(x), act_quant=jq))
    _close(got.numpy(), want, tol=ACT_QUANT_TOL, what="full DFQ logits")
    assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() >= 0.9

    fp = tm.apply_folded(hostile, torch.from_numpy(x)).numpy()
    naive = tm.apply_folded(tm.quantize_weights(hostile, spec),
                            torch.from_numpy(x), act_quant=tq).numpy()

    def sqnr(y):
        return 10 * np.log10((fp ** 2).sum() / ((fp - y) ** 2).sum())

    assert sqnr(got.numpy()) > sqnr(naive) + 3.0
