"""The port's model against the JAX package's ``LMModel`` at smoke size.

Weights are made on the JAX side (``model.init`` or a full serving recipe,
``serve-w8a8-kv8`` or ``serve-w8a16-kv8``), converted to numpy inside the
test and carried across with ``repro_torch.weights.from_jax_numpy``; both
models then run the same tokens through a prefill and 16 teacher-forced
decode steps over the per-slot int8 KV cache. Tolerances, measured on this
CPU:

  * fp32 weights — logits within atol 2e-5 (measured max 4.2e-7 at token
    seed 1). Any single int8 KV rounding flip (a K/V value within ~1e-7 of a
    .5 boundary, moved across by float32 summation order) shifts logits by
    ~4e-4: token seed 0 has one (measured 6.6e-4), so the test pins seed 1.
  * serve-w8a8-kv8 weights (norm folding, CLE, bias absorption, int8 pack)
    — greedy tokens identical and logits within atol 1e-5 (measured max
    2.4e-7 on both the JAX ``xla`` and ``ref`` tiers, token seed 0).
  * serve-w8a16-kv8 weights — every projection is now a float32 product
    that XLA and PyTorch sum in different orders, so a K/V value may round
    one int8 step apart. At token seed 0: greedy tokens identical, the int8
    cache bit-equal, logits within atol 1e-5 (measured max 4.2e-7 on
    ``xla``, 4.5e-7 on ``ref``). Token seed 3 on ``ref`` has one V flip
    (logits 9.5e-5 apart; ROADMAP Queue C).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.quantized.ptq import quantize_for_serving as jax_quantize_for_serving
from repro.quantized.qtensor import QTensor as JaxQTensor

from repro_torch import get_config
from repro_torch.models import build_model
from repro_torch.quantized import QTensor, quantize_for_serving
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b"


def jax_to_numpy(tree):
    """The JAX params tree as nested dicts of numpy arrays, each QTensor as
    {"q", "scale", "mode"}."""
    if isinstance(tree, JaxQTensor):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "mode": tree.mode}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def fp32_pair():
    cfg = jax_get_config(ARCH, smoke=True)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(f"{ARCH}-smoke")
    return jm, jp, build_model(tcfg), from_jax_numpy(jax_to_numpy(jp), tcfg,
                                                     device="cpu")


RECIPES = ["serve-w8a8-kv8", "serve-w8a16-kv8"]


@pytest.fixture(scope="module", params=RECIPES)
def served_pair(request):
    qm = repro.quantize(f"{ARCH}-smoke", recipe=request.param)
    tcfg = get_config(f"{ARCH}-smoke")
    return (qm.model, qm.params, build_model(tcfg),
            from_jax_numpy(jax_to_numpy(qm.params), tcfg, device="cpu"))


def _roll(jm, jp, tm, tp, seed, steps=16, prefill=8):
    """Teacher-forced logits [prefill + steps, B, V] from both models."""
    B = 2
    toks = np.random.RandomState(seed).randint(
        0, 256, (B, prefill + steps)).astype(np.int32)
    jc = jm.init_cache(B, 32, dtype=jnp.float32, per_slot=True, kv_bits=8)
    tc = tm.init_cache(B, 32, device="cpu", kv_bits=8)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :prefill]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :prefill]).long(), tc)
    lj, lt = [np.asarray(jl)], [tl.numpy()]
    for t in range(prefill, prefill + steps):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        lj.append(np.asarray(jl))
        lt.append(tl.numpy())
    return np.stack(lj), np.stack(lt), jc, tc


# ------------------------------------------------------------ carry-over

def test_weight_carry_over(served_pair):
    """A JAX serving tree comes across with its QTensor mode and K-major
    storage."""
    jm, jp, _, tp = served_pair
    mode = jp["blocks"]["attn"]["wq"].mode
    jn = jax_to_numpy(jp)

    def walk(j, t, path=()):
        if isinstance(t, QTensor):
            assert set(j) == {"q", "scale", "mode"} and t.mode == j["mode"]
            np.testing.assert_array_equal(t.q.numpy(), j["q"])
            np.testing.assert_array_equal(t.scale.numpy(), j["scale"])
            assert t.q.transpose(-1, -2).is_contiguous(), path  # K-major
            return 1
        if isinstance(t, dict):
            assert set(t) == set(j), path
            return sum(walk(j[k], t[k], path + (k,)) for k in t)
        np.testing.assert_array_equal(t.numpy(), j)
        assert t.numpy().dtype == j.dtype
        return 0

    assert walk(jn, tp) == 7                # wq wk wv wo wg wu wd
    assert {tp["blocks"][b][w].mode for b, ws in (
        ("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wg", "wu", "wd")))
        for w in ws} == {mode}
    assert tp["blocks"]["attn"]["wq"].q.shape == (2, 64, 64)


def test_carry_over_rejects_a_mismatched_config(fp32_pair):
    _, jp, _, _ = fp32_pair
    cfg = dataclasses.replace(get_config(f"{ARCH}-smoke"), n_layers=3)
    with pytest.raises(ValueError, match="stacked blocks"):
        from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")


def test_pack_matches_jax_quantize_for_serving(fp32_pair):
    """The port's pack stage over its ``dfq_plan`` sites == the JAX pack
    stage over the JAX plan's, bit for bit, in both modes."""
    jm, jp, tm, tp = fp32_pair
    plan = tm.dfq_plan()
    for mode in ("w8a8", "w8a16"):
        jq = jax_quantize_for_serving(jp, jm.dfq_plan(), mode=mode)
        tq = quantize_for_serving(tp, plan, mode=mode)
        for site in plan.sites:
            j, t = jq, tq
            for k in site.w:
                j, t = j[k], t[k]
            assert t.mode == j.mode == mode
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert [s.name for s in plan.sites] == [s.name for s in jm.dfq_plan().sites]


# ---------------------------------------------------------- forward parity

def test_fp32_prefill_decode_matches_jax(fp32_pair):
    jm, jp, tm, tp = fp32_pair
    lj, lt, jc, tc = _roll(jm, jp, tm, tp, seed=1)
    np.testing.assert_allclose(lt, lj, atol=2e-5, rtol=0)
    for k in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("tier", ["xla", "ref"])
def test_w8a8_prefill_decode_matches_jax(served_pair, tier, monkeypatch):
    """The JAX model on its default CPU serving tier (xla: plain softmax)
    and on its ref tier (the blocked online softmax the port mirrors), for
    each serving recipe's weights."""
    if tier == "ref":
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "ref")
    jm, jp, tm, tp = served_pair
    lj, lt, jc, tc = _roll(jm, jp, tm, tp, seed=0)
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    np.testing.assert_array_equal(tc["v"].numpy(), np.asarray(jc["v"]))


def test_bf16_compute_casts_params_once():
    """A bf16 model casts its float32 leaves (QTensor scales included, as
    the JAX forward does) once per params tree, not every step."""
    cfg = dataclasses.replace(get_config(f"{ARCH}-smoke"), dtype="bfloat16")
    m = build_model(cfg)
    p = quantize_for_serving(m.init(0, device="cpu"), m.dfq_plan(),
                             mode="w8a8")
    cache = m.init_cache(2, 16, device="cpu", kv_bits=8)
    lg, cache = m.prefill(p, torch.zeros((2, 4), dtype=torch.long), cache)
    prepared = m._prepared
    lg2, _ = m.decode_step(p, lg.argmax(-1)[:, None], cache)
    assert m._prepared is prepared
    assert prepared[1]["embed"].dtype == torch.bfloat16
    assert prepared[2][0]["attn"]["wq"].scale.dtype == torch.bfloat16
    assert lg2.dtype == torch.bfloat16 and torch.isfinite(lg2.float()).all()


def test_init_is_seeded_and_shaped():
    cfg = get_config(f"{ARCH}-smoke")
    m = build_model(cfg)
    a, b = m.init(3, device="cpu"), m.init(3, device="cpu")
    assert torch.equal(a["blocks"]["mlp"]["wg"], b["blocks"]["mlp"]["wg"])
    assert a["blocks"]["attn"]["wq"].shape == (2, 64, 64)
    assert a["blocks"]["attn"]["wk"].shape == (2, 64, 32)
    assert a["embed"].shape == (256, 64)
    n = a["embed"].numel() + sum(            # weight matrices: [L, in, out]
        t.numel() for t in (*a["blocks"]["attn"].values(),
                            *a["blocks"]["mlp"].values()) if t.ndim == 3)
    assert n == cfg.param_count()


def test_unported_features_raise():
    cfg = get_config(f"{ARCH}-smoke")
    with pytest.raises(NotImplementedError, match="family"):
        build_model(dataclasses.replace(cfg, family="retnet"))
    m = build_model(cfg)
    with pytest.raises(ValueError, match="kv_bits must be 8 or 16"):
        m.init_cache(1, 8, device="cpu", kv_bits=4)
    from repro_torch.kernels.qmatmul_w8a16 import (
        qmatmul_w8a16,
        qmatmul_w8a16_q8_ref,
    )
    a = torch.linspace(-1, 1, 12).reshape(3, 4)
    w = torch.arange(-4, 4, dtype=torch.int8).reshape(4, 2)
    q, s = qmatmul_w8a16(a, w, torch.ones(1), quantize_out=True)
    qr, sr = qmatmul_w8a16_q8_ref(a, w, torch.ones(1))
    assert torch.equal(q, qr) and torch.equal(s, sr)
    from repro_torch.models.layers import mlp_block
    with pytest.raises(NotImplementedError, match="activation"):
        mlp_block({"wu": torch.eye(4), "wd": torch.eye(4)},
                  torch.zeros((1, 4)), "tanh")


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_decode_asks_quantize_out_only_for_a_w8a8_wo(mode, monkeypatch):
    """The fused decode's quantize-out epilogue feeds a W8A8 ``wo`` only; a
    W8A16 ``wo`` reads the fp output (as ``repro/models/layers.py:516``)."""
    from repro_torch.models import layers

    seen = []
    real = layers.fused_decode

    def spy(*args, **kwargs):
        seen.append(kwargs["quantize_out"])
        return real(*args, **kwargs)

    monkeypatch.setattr(layers, "fused_decode", spy)
    m = build_model(get_config(f"{ARCH}-smoke"))
    p = quantize_for_serving(m.init(0, device="cpu"), m.dfq_plan(), mode=mode)
    cache = m.init_cache(2, 8, device="cpu", kv_bits=8)
    lg, cache = m.prefill(p, torch.zeros((2, 3), dtype=torch.long), cache)
    m.decode_step(p, lg.argmax(-1)[:, None], cache)
    assert seen == [mode == "w8a8"] * m.cfg.n_layers


def test_w8a16_kv_rounding_flip_stays_small(monkeypatch):
    """Token seed 3 under serve-w8a16-kv8 against the JAX ``ref`` tier: the
    float32 products sum in different orders, so a K/V value may quantize
    one int8 step apart (one V value on this CPU; ROADMAP Queue C). Such a
    flip moves later logits by ~1e-4 and leaves the greedy tokens equal:
    at most one cache value apart by one step, logits within atol 2e-4."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "ref")
    qm = repro.quantize(f"{ARCH}-smoke", recipe="serve-w8a16-kv8")
    tcfg = get_config(f"{ARCH}-smoke")
    tp = from_jax_numpy(jax_to_numpy(qm.params), tcfg, device="cpu")
    lj, lt, jc, tc = _roll(qm.model, qm.params, build_model(tcfg), tp, seed=3)
    flips = {k: (tc[k].numpy().astype(np.int32)
                 - np.asarray(jc[k]).astype(np.int32)) for k in ("k", "v")}
    n_flips = sum(int((d != 0).sum()) for d in flips.values())
    print(f"token seed 3: {n_flips} int8 K/V flips, max |logit diff| "
          f"{np.abs(lt - lj).max():.3g}")
    assert n_flips <= 1 and max(int(np.abs(d).max()) for d in flips.values()) <= 1
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
    np.testing.assert_allclose(lt, lj, atol=2e-4, rtol=0)
