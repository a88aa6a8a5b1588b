"""The port's stepwise serving engine against the JAX ``ServingEngine``
(the fast path: test_torch_engine_fast.py).

Both engines serve the same ``synthetic_trace`` over
``repro.quantize("qwen2-0.5b-smoke", recipe=r)`` weights (carried across
through numpy), for r in ``serve-w8a8-kv8`` and ``serve-w8a16-kv8``, with
the stepwise path (``fast=False``) and an int8 KV pool. Per-request
tokens, admission/finish ticks and the stats counters must be identical —
against the JAX ``ref`` tier (the same blocked online softmax the port's
plain version runs, selected only through ``monkeypatch.setenv``) and
against the JAX default CPU tier (``xla``, plain softmax; identical at
this trace seed — the logits agree within atol 1e-5, test_torch_model.py,
measured max 4.5e-7 under serve-w8a16-kv8, where every projection is a
float32 product summed in another order than XLA's).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
from repro.quantized.qtensor import QTensor as JaxQTensor
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import synthetic_trace as jax_synthetic_trace

import repro_torch
from repro_torch import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import build_model
from repro_torch.serving import (
    CachePool,
    QueueFull,
    Request,
    RequestTooLarge,
    ServingEngine,
    synthetic_trace,
)
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b-smoke"
ENGINE = dict(num_slots=4, max_len=64, prefill_chunk=8)
TRACE = dict(vocab_size=256, prompt_lens=(3, 24), gen_lens=(1, 16),
             mean_interarrival=0.7)


def _numpy(tree):
    if isinstance(tree, JaxQTensor):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "mode": tree.mode}
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module", params=["serve-w8a8-kv8", "serve-w8a16-kv8"])
def served(request):
    qm = repro.quantize(ARCH, recipe=request.param)
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = from_jax_numpy(_numpy(qm.params), cfg, device="cpu")
    eng = ServingEngine(model, params, cfg, device="cpu", fast=False, kv_bits=8,
                        **ENGINE)
    reset_launch_counts()
    results = eng.run(synthetic_trace(0, 10, **TRACE))
    return qm, (model, params, cfg), eng, results


def _jax_run(qm):
    eng = JaxServingEngine(qm.model, qm.params, qm.cfg, fast=False, kv_bits=8,
                           **ENGINE)
    return eng, eng.run(jax_synthetic_trace(0, 10, **TRACE))


def test_trace_matches_jax_trace():
    a = synthetic_trace(5, 6, **TRACE)
    b = jax_synthetic_trace(5, 6, **TRACE)
    for x, y in zip(a, b):
        assert (x.rid, list(x.prompt), x.max_new_tokens, x.arrival) == \
               (y.rid, list(y.prompt), y.max_new_tokens, y.arrival)


@pytest.mark.parametrize("tier", ["ref", "xla"])
def test_tokens_and_timeline_match_jax_engine(served, tier, monkeypatch):
    if tier == "ref":
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "ref")
    qm, _, eng, results = served
    jeng, jres = _jax_run(qm)
    assert sorted(results) == sorted(jres) == list(range(10))
    for rid in jres:
        assert results[rid].tokens == jres[rid].tokens, rid
        assert results[rid].admitted_at == jres[rid].admitted_at
        assert results[rid].finished_at == jres[rid].finished_at
        assert results[rid].status == jres[rid].status == "ok"
    for k in ("decode_steps", "decode_dispatches", "prefill_chunks",
              "prefill_dispatches", "host_syncs", "generated_tokens",
              "occupancy_sum", "engine_steps", "shed", "quarantined"):
        assert eng.stats[k] == jeng.stats[k], k


def test_cpu_serving_launches_no_kernel(served):
    """On the CPU every op is the plain version: no launch is counted."""
    assert set(launch_counts().values()) == {0}


def test_batch_invariance(served):
    """A request's tokens are the same served alone or in a mixed batch:
    masked keys contribute exact zeros, so recycled slots are exact."""
    _, (model, params, cfg), _, mixed = served
    solo = ServingEngine(model, params, cfg, device="cpu", kv_bits=8, **ENGINE)
    for r in synthetic_trace(0, 10, **TRACE)[:4]:
        out = solo.run([dataclasses.replace(r, arrival=0.0)])
        assert out[r.rid].tokens == mixed[r.rid].tokens
        assert solo.pool.all_free()


def test_prefill_leaves_other_slots_untouched(served):
    """A masked prefill chunk restores the ring window it wrote in every
    row but its own: a slot mid-decode keeps its cache bytes."""
    _, (model, params, cfg), _, _ = served
    eng = ServingEngine(model, params, cfg, device="cpu", fast=False, kv_bits=8,
                        **ENGINE)
    eng.submit(Request(rid=0, prompt=list(range(5)), max_new_tokens=4))
    eng.step()
    eng.step()
    before = {k: v.clone() for k, v in eng.pool.cache.items()}
    chunk = np.arange(1, 9, dtype=np.int64)[None]
    eng._prefill_chunk_impl(chunk, slot=1, n_valid=8)
    after = eng.pool.cache
    for k in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(after[k][:, 0], before[k][:, 0]), k
        assert not torch.equal(after[k][:, 1], before[k][:, 1]), k
    assert torch.equal(after["kpos"][0], before["kpos"][0])
    assert int(after["pos"][1]) == 8 and int(after["pos"][0]) == int(before["pos"][0])


def test_admission_errors(served):
    _, (model, params, cfg), _, _ = served
    eng = ServingEngine(model, params, cfg, device="cpu", num_slots=1,
                        max_len=16, prefill_chunk=8, max_queue=1, kv_bits=8)
    with pytest.raises(RequestTooLarge):
        eng.submit(Request(rid=0, prompt=[1] * 12, max_new_tokens=8))
    # a deadline is taken (it finishes before it: status ok)
    eng.submit(Request(rid=1, prompt=[1], max_new_tokens=1, deadline=3.0))
    with pytest.raises(QueueFull):
        eng.submit(Request(rid=3, prompt=[1], max_new_tokens=1))
    assert eng.stats["shed"] == 1
    res = eng.run()
    assert res[1].tokens and res[1].status == "ok" and eng.pool.all_free()


def test_cache_pool_lifecycle(served):
    _, (model, _, _), _, _ = served
    pool = CachePool(model, 2, 8, device="cpu", kv_bits=8)
    assert pool.bytes_per_slot() == 2 * 2 * 8 * 2 * (16 + 4)
    a, b = pool.allocate(), pool.allocate()
    assert (a, b) == (0, 1) and pool.n_free == 0
    pool.cache["pos"][1] = 5
    pool.release(1)
    assert pool.allocate() == 1 and int(pool.cache["pos"][1]) == 0
    pool.release(1)
    with pytest.raises(ValueError, match="not allocated"):
        pool.release(1)
    pool.check_invariants()


def test_serve_entry_point_on_cpu(capsys):
    run = repro_torch.serve(repro_torch.ServeConfig(
        arch="qwen2-0.5b", smoke=True, device="cpu", slots=2, trace=3,
        prompt_len=10, gen_len=4, prefill_chunk=4, profile=True))
    assert len(run.results) == 3
    assert all(r.status == "ok" for r in run.results.values())
    assert run.generated_tokens == sum(len(r.tokens)
                                       for r in run.results.values())
    out = capsys.readouterr().out
    # the default deployment, the JAX launcher's: W8A16 over the fp cache
    assert "with recipe 'serve-w8a16'" in out and "kv cache: fp" in out
    for stage in ("fold_norm", "cle", "bias_absorb", "pack"):
        assert f"  {stage}: " in out
    assert "per-site weight SQNR (dB): wq" in out
    assert [r["stage"] for r in run.report] == [
        "fold_norm", "cle", "bias_absorb", "pack"]
    assert "profile: the profiler recorded no device time" in out  # CPU


def test_serve_parser_is_derived_from_the_config():
    from repro_torch.launch.serve_config import ServeConfig, build_parser

    ns = build_parser().parse_args(["--smoke", "--device", "cpu",
                                    "--trace", "5", "--slots", "8",
                                    "--profile"])
    cfg = ServeConfig.from_args(ns)
    assert (cfg.smoke, cfg.device, cfg.trace, cfg.slots, cfg.profile) == \
           (True, "cpu", 5, 8, True)
    assert ServeConfig.from_args(build_parser().parse_args([])) == ServeConfig()
    assert ServeConfig().quantize == "w8a16"
    ns = build_parser().parse_args(["--quantize", "w8a8", "--kv-bits", "8"])
    assert (ServeConfig.from_args(ns).quantize,
            ServeConfig.from_args(ns).kv_bits) == ("w8a8", 8)
    ns = build_parser().parse_args(["--quantize", "none", "--kv-bits", "16"])
    assert (ServeConfig.from_args(ns).quantize,
            ServeConfig.from_args(ns).kv_bits) == ("none", 16)
    assert ServeConfig().kv_bits is None
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--quantize", "w4a16"])
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--kv-bits", "4"])
    with pytest.raises(repro_torch.ServeConfigError):
        ServeConfig(slots=0).validate()
    with pytest.raises(repro_torch.ServeConfigError, match="quantize"):
        ServeConfig(quantize="w4a16").validate()
