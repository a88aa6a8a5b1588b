"""The port's training substrate against ``tests/test_substrate.py``'s
checks of the JAX package, case for case where the port has the piece
(optimizer, schedule, data, checkpointing, fault tolerance, gradient
compression, quantized serving), plus bit-equality with the JAX functions
on the same inputs.

Bit-equal: ``cosine_schedule`` (its float32 operations in the reference's
order, the C library's ``cosf``), ``ef_compress`` (scale, payload and
residual), ``token_batch`` (the ids; the C library's ``powf``: see
``repro_torch.data.token_batch``) and ``dequantize_params``. The gathered
mean of ``compressed_mean`` is a float32 contraction over the ranks, held
within 1e-6 of its scale (``tensordot``'s order of the n products).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.data import token_batch as jax_token_batch
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro.optim import ef_compress as jax_ef_compress
from repro.quantized import QTensor as JaxQTensor
from repro.quantized import dequantize_params as jax_dequantize_params

from _torch_port import jax_to_numpy
from repro_torch.checkpoint import CheckpointError, Checkpointer
from repro_torch.data import (
    TokenStream,
    calibration_tokens,
    synthetic_image_batch,
    token_batch,
)
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    compressed_mean,
    cosine_schedule,
    ef_compress,
    ef_init,
)
from repro_torch.optim.compression import gathered_mean
from repro_torch.quantized import QTensor, dequantize_params, quantize_param
from repro_torch.runtime import (
    FaultTolerantLoop,
    StragglerMonitor,
    elastic_restore,
    shard_assignment,
)
from repro_torch.weights import from_jax_numpy


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else a.dtype)


# ------------------------------------------------------------------ optimizer
def test_adamw_reduces_quadratic_loss():
    gen = torch.Generator().manual_seed(0)
    target = torch.randn(8, 8, generator=gen)
    params = {"w": torch.zeros(8, 8)}
    state = adamw_init(params)
    l0 = float(((params["w"] - target) ** 2).mean())
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        g, = torch.autograd.grad(((w - target) ** 2).mean(), w)
        params, state, _ = adamw_update({"w": g}, state, params, lr=3e-2,
                                        weight_decay=0.0)
    assert float(((params["w"] - target) ** 2).mean()) < 0.01 * l0


def test_adamw_clips_global_norm():
    params = {"w": torch.zeros(4)}
    _, _, gn = adamw_update({"w": torch.full((4,), 1e9)}, adamw_init(params),
                            params, lr=1e-3, clip_norm=1.0)
    assert float(gn) > 1e8  # reported pre-clip norm


def test_cosine_schedule_shape():
    assert float(cosine_schedule(0, peak_lr=1.0, warmup=10, total=100)) == 0.0
    assert abs(float(cosine_schedule(10, peak_lr=1.0, warmup=10,
                                     total=100)) - 1.0) < 1e-6
    assert float(cosine_schedule(100, peak_lr=1.0, warmup=10, total=100)) <= 0.11


@pytest.mark.parametrize("peak_lr,warmup,total", [
    (1e-3, 20, 60), (1e-3, 20, 100), (3e-4, 100, 10000), (1.0, 10, 100),
    (1e-3, 20, 7), (0.0, 0, 1)])
def test_cosine_schedule_is_bit_equal(peak_lr, warmup, total):
    """Every step from 0 past the end, as an int and as the optimizer's
    int32 step tensor (on its device), against the JAX function."""
    for s in range(0, min(total + 30, 400)):
        want = _bits(jax_cosine_schedule(s, peak_lr=peak_lr, warmup=warmup,
                                         total=total))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = cosine_schedule(step, peak_lr=peak_lr, warmup=warmup,
                                  total=total)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert _bits(got) == want, (s, float(got))


# ----------------------------------------------------------------------- data
def test_token_batch_deterministic_and_shard_independent():
    a = token_batch(0, step=3, shard=1, batch=4, seq=16, vocab=100,
                    device="cpu")
    b = token_batch(0, step=3, shard=1, batch=4, seq=16, vocab=100,
                    device="cpu")
    c = token_batch(0, step=3, shard=2, batch=4, seq=16, vocab=100,
                    device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].max()) < 100


def test_labels_are_next_tokens():
    b = token_batch(0, 0, 0, 2, 8, 50, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (2, 8)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("seed,shard,vocab", [
    (0, 0, 151936), (1, 0, 256), (7, 3, 151936), (12345, 1, 1000)])
def test_token_batch_is_bit_equal(seed, shard, vocab):
    """The ids of every step 0-39 (8 x 65 draws each; the Zipf head, where
    ``u^(-1/1.1) - 1`` lands near small integers, among them) equal the
    JAX package's, through ``TokenStream`` as the launcher reads them."""
    stream = TokenStream(seed=seed, shard=shard, n_shards=4,
                         batch_per_shard=8, seq=64, vocab=vocab, device="cpu")
    for step in range(40):
        want = jax_token_batch(seed, step, shard, 8, 64, vocab)
        got = stream.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"step {step} {k}")


def test_calibration_tokens_data_free():
    t1 = calibration_tokens(0, 4, 32, 1000, device="cpu")
    assert torch.equal(t1, calibration_tokens(0, 4, 32, 1000, device="cpu"))


def test_synthetic_images_class_structure():
    b = synthetic_image_batch(0, 0, 64, 16, 3, 4, device="cpu")
    assert b["x"].shape == (64, 16, 16, 3)
    assert set(b["y"].unique().tolist()) <= set(range(4))


# ----------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4) * 2}}
    ckpt.save(5, tree, blocking=True)
    restored, step = ckpt.restore(tree)
    assert step == 5
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_restores_into_the_target_structure(tmp_path):
    """A (params, AdamWState) tuple comes back as the target's own types,
    the dict keys in the target's order, every leaf bit-equal, on the
    target's device; a leaf count or a shape that differs is refused by
    name."""
    params = {"w": torch.randn(3, 4), "b": torch.randn(4),
              "blocks": [{"x": torch.randn(2)}, {"x": torch.randn(2)}]}
    state = (params, adamw_init(params))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(3, state, blocking=True)
    got, step = ckpt.restore((
        {k: params[k] for k in ("w", "blocks", "b")}, adamw_init(params)))
    assert step == 3 and isinstance(got, tuple)
    assert isinstance(got[1], AdamWState) and list(got[0]) == ["w", "blocks", "b"]
    assert isinstance(got[0]["blocks"], list)
    assert torch.equal(got[0]["blocks"][1]["x"], params["blocks"][1]["x"])
    assert got[1].step.dtype == torch.int32
    with pytest.raises(CheckpointError, match="leaves"):
        ckpt.restore(params)
    bad = dict(params, w=torch.zeros(4, 3))
    with pytest.raises(CheckpointError, match="leaf 0/w"):
        ckpt.restore((bad, adamw_init(bad)))


def test_checkpoint_retention_and_latest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"a": torch.zeros(3)}, blocking=True)
    assert ckpt.latest_step() == 4
    dirs = sorted(os.listdir(tmp_path))
    assert "step_1" not in dirs and "step_2" not in dirs


def test_checkpoint_ignores_partial_writes(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"a": torch.zeros(3)}, blocking=True)
    os.makedirs(tmp_path / "step_9.tmp-123")  # simulated crash mid-write
    assert ckpt.latest_step() == 1
    Checkpointer(str(tmp_path))  # restart cleans tmp
    assert not any(".tmp" in d for d in os.listdir(tmp_path))


def test_checkpoint_async(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(7, {"a": torch.arange(1000)}, blocking=False)
    ckpt.wait()
    assert ckpt.latest_step() == 7


def test_shard_assignment():
    """The elastic path's data assignment (``elastic_restore`` below; onto
    meshes of several ranks in tests/test_torch_train_sharded.py)."""
    assert shard_assignment(64, 4, 3) == (3, 16)
    with pytest.raises(ValueError, match="does not split"):
        shard_assignment(10, 4, 0)


def test_elastic_restore_onto_new_mesh(tmp_path, gloo_group):
    """The reference's ``test_elastic_restore_onto_new_mesh``: a checkpoint
    restored onto a "new" one-rank mesh by ``elastic_restore``, bit for
    bit; the JAX package's ``elastic_restore`` reads the same checkpoint to
    the same leaves."""
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    from repro.runtime.elastic import elastic_restore as jax_elastic_restore
    from repro_torch.launch.mesh import make_production_mesh

    ckpt = Checkpointer(str(tmp_path / "ck"))
    w = torch.arange(512, dtype=torch.float32).reshape(2, 16, 16)
    tree = {"blocks": {"w": w}}
    ckpt.save(1, tree, blocking=True)
    mesh = make_production_mesh(shape=(1, 1), device="cpu")
    restored, step = elastic_restore(ckpt, tree, mesh)
    assert step == 1 and torch.equal(restored["blocks"]["w"], w)
    jtree = {"blocks": {"w": jnp.arange(512, dtype=jnp.float32).reshape(
        2, 16, 16)}}
    jrest, jstep = jax_elastic_restore(JaxCheckpointer(str(tmp_path / "ck")),
                                       jtree, jax.make_mesh((1,), ("data",)))
    assert jstep == 1
    assert np.array_equal(np.asarray(jrest["blocks"]["w"]), w.numpy())


# ----------------------------------------------------------- fault tolerance
def _toy_step(state, batch):
    state = {"x": state["x"] + batch["tokens"].sum() * 0 + 1}
    return state, {"loss": 1.0 / float(state["x"])}


def _data(s):
    return token_batch(0, s, 0, 2, 8, 50, device="cpu")


def test_ft_loop_runs_and_checkpoints(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    loop = FaultTolerantLoop(_toy_step, _data, ckpt, ckpt_every=5)
    state, end = loop.run({"x": torch.zeros(())}, 0, 12)
    assert end == 12 and loop.metrics.steps_run == 12
    assert ckpt.latest_step() == 12


def test_ft_loop_retries_and_restores(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(0, {"x": torch.zeros(())}, blocking=True)
    fired = []

    def inject(step):
        if step == 7 and step not in fired:
            fired.append(step)
            return True
        return False

    loop = FaultTolerantLoop(_toy_step, _data, ckpt, ckpt_every=5)
    state, end = loop.run({"x": torch.zeros(())}, 0, 10, inject_failure=inject)
    assert end == 10
    assert loop.metrics.retries == 1 and loop.metrics.restores == 1
    # replayed from the step-5 checkpoint: every step counted exactly once
    assert float(state["x"]) == 10.0


def test_ft_loop_preemption_checkpoint(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    loop = FaultTolerantLoop(_toy_step, _data, ckpt, ckpt_every=100)
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            loop.request_preemption()
        return _toy_step(state, batch)

    loop.step_fn = step_fn
    state, end = loop.run({"x": torch.zeros(())}, 0, 50)
    assert loop.metrics.preempted and end == 3
    assert ckpt.latest_step() == 3  # clean preemption checkpoint


def test_ft_loop_bounds_retries_and_aborts_on_nan(tmp_path):
    """A step that fails every time is retried ``max_retries_per_step``
    times, then raised; a non-finite loss counts as a failure."""
    loop = FaultTolerantLoop(lambda s, b: (s, {"loss": float("nan")}), _data,
                             Checkpointer(str(tmp_path)),
                             max_retries_per_step=2)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        loop.run({"x": torch.zeros(())}, 0, 3)
    assert loop.metrics.retries == 3 and loop.metrics.steps_run == 0


def test_straggler_monitor_detects_slow_steps():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=1)
    for s in range(10):
        mon.observe(s, 0.1)
    assert mon.observe(10, 0.5)  # 5× slower
    assert len(mon.events) == 1
    assert not mon.observe(11, 0.11)  # EMA not poisoned by the spike


# ------------------------------------------------------ gradient compression
def test_ef_compress_error_feedback_unbiased():
    """Error feedback makes the LONG-RUN compressed sum match fp."""
    g = torch.randn(256, generator=torch.Generator().manual_seed(0)) * 0.01
    residual = ef_init({"g": g})["g"]
    acc_q = torch.zeros_like(g)
    for _ in range(50):
        q, scale, residual = ef_compress(g, residual)
        acc_q = acc_q + q.float() * scale
    acc_fp = g * 50
    assert float((acc_q - acc_fp).norm() / acc_fp.norm()) < 0.01


def test_ef_compress_is_bit_equal():
    """Payload, scale and residual against the JAX function, over inputs
    from 1e-4 to 1e2 in scale (a zero one among them: the 1e-12 floor)."""
    rng = np.random.RandomState(0)
    for i in range(30):
        g = (rng.randn(1025) * 10 ** rng.uniform(-4, 2)).astype(np.float32)
        if i == 0:
            g[:] = 0
        r = (rng.randn(1025) * 1e-3).astype(np.float32)
        jq, js, jr = jax_ef_compress(jnp.asarray(g), jnp.asarray(r))
        q, s, nr = ef_compress(torch.from_numpy(g), torch.from_numpy(r))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert _bits(s) == _bits(js)
        np.testing.assert_array_equal(_bits(nr), _bits(jr))


@pytest.fixture
def gloo_group(tmp_path):
    """An in-process gloo group of one rank, torn down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compressed_mean_over_a_group_of_one(gloo_group):
    """As the reference's test over a mesh of one: the mean plus the new
    residual gives g back."""
    g = torch.randn(64, generator=torch.Generator().manual_seed(1))
    mean, new_r = compressed_mean(g, torch.zeros_like(g), gloo_group)
    np.testing.assert_allclose((mean + new_r).numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-6)
    q, s, r = ef_compress(g, torch.zeros_like(g))
    assert torch.equal(new_r, r)
    assert torch.equal(mean, q.float() * (s / 1))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gathered_mean_matches_jax_tensordot(n):
    """The dequantized mean of n ranks' payloads, as ``compressed_mean``
    takes it after the all-gather, against the reference's
    ``tensordot(s_all / n, q_all)``."""
    rng = np.random.RandomState(n)
    q_all = rng.randint(-127, 128, (n, 33, 7)).astype(np.int8)
    s_all = (rng.rand(n) * 1e-2).astype(np.float32)
    want = np.asarray(jnp.tensordot(jnp.asarray(s_all) / n,
                                    jnp.asarray(q_all).astype(jnp.float32),
                                    axes=((0,), (0,))))
    got = gathered_mean(torch.from_numpy(q_all), torch.from_numpy(s_all))
    assert got.shape == (33, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------- quantized serving
def test_qtensor_roundtrip_and_dispatch():
    from repro_torch.models.layers import linear

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, 32, generator=gen) * 0.1
    qt = quantize_param(w, per_channel=True)
    assert float((qt.dequant() - w).abs().max()) <= float(qt.scale.max()) * 0.51
    x = torch.randn(4, 8, 64, generator=gen)
    y_fp, y_q = linear(x, w), linear(x, qt)
    assert float((y_q - y_fp).norm() / y_fp.norm()) < 0.02


def test_dequantize_params_is_bit_equal():
    """Each QTensor's float32 image against the JAX function's, the other
    leaves passed through."""
    rng = np.random.RandomState(0)
    q = rng.randint(-127, 128, (3, 16, 8)).astype(np.int8)
    scale = rng.rand(3, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    jtree = {"blocks": {"w": JaxQTensor(jnp.asarray(q), jnp.asarray(scale),
                                        "w8a16"), "b": jnp.asarray(b)}}
    ttree = {"blocks": {"w": QTensor(torch.from_numpy(q),
                                     torch.from_numpy(scale), "w8a16"),
                        "b": torch.from_numpy(b)}}
    want = jax_dequantize_params(jtree)
    got = dequantize_params(ttree)
    np.testing.assert_array_equal(_bits(got["blocks"]["w"]),
                                  _bits(want["blocks"]["w"]))
    assert got["blocks"]["b"] is ttree["blocks"]["b"]


def test_quantized_lm_serving_end_to_end():
    """DFQ → int8 serving params → prefill matches fp within int8 noise,
    and parameter bytes shrink > 2x (the reference's weights carried
    across)."""
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model

    from repro_torch import get_config
    from repro_torch.core import DFQConfig, apply_dfq
    from repro_torch.models import build_model
    from repro_torch.quantized import quantize_for_serving, serving_summary

    jp = jax_build_model(jax_get_config("qwen2-0.5b", smoke=True)).init(
        jax.random.PRNGKey(0))
    cfg = get_config("qwen2-0.5b", smoke=True)
    model = build_model(cfg)
    params = from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")
    plan = model.dfq_plan()
    params_eq = apply_dfq(params, plan, DFQConfig())
    qparams = quantize_for_serving(params_eq, plan, mode="w8a16")
    tokens = calibration_tokens(1, 2, 8, cfg.vocab_size, device="cpu")
    lf, _ = model.prefill(params_eq, tokens, model.init_cache(
        2, 16, device="cpu", per_slot=False, dtype=torch.float32))
    lq, _ = model.prefill(qparams, tokens, model.init_cache(
        2, 16, device="cpu", per_slot=False, dtype=torch.float32))
    assert float((lq - lf).norm() / lf.norm()) < 0.05
    assert serving_summary(qparams)["compression"] > 2.0
    back = dequantize_params(qparams)
    assert not any(isinstance(v, QTensor) for v in back["blocks"]["attn"].values())
