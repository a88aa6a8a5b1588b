"""The port's fast serving path against the JAX ``ServingEngine(fast=True)``.

On the CPU the fast path runs its dispatches eagerly — one full-width
prefill for every prefilling slot, the slot reset folded into the first
chunk, K decode steps a dispatch with one host sync — the same code the
card captures into CUDA graphs. Both engines serve the same requests over
weights made on the JAX side and carried across through numpy
(``from_jax_numpy``): per-request tokens, admission and finish ticks,
status, the stats counters and the mean occupancy must be identical, at
horizons 1, 3 and 8, and equal to the port's own stepwise run. The other
tests mirror the JAX engine's fast-path tests (dispatch and sync counts,
the arrival cap of the horizon, warmup isolation), plus what the graphs
rely on: ``warmup()`` and a whole fast run keep every ``pool.cache`` leaf
at its address.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import repro
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import synthetic_trace as jax_synthetic_trace

import repro_torch
from repro_torch import get_config
from repro_torch.kernels import dispatch
from repro_torch.models import build_model
from repro_torch.runtime import StragglerMonitor
from repro_torch.serving import CachePool, Request, ServingEngine, synthetic_trace
from repro_torch.weights import from_jax_numpy

from _torch_port import jax_to_numpy

ARCH = "qwen2-0.5b-smoke"
RECIPES = ["serve-w8a8-kv8", "serve-w8a16-kv8"]
HORIZONS = [1, 3, 8]
# the engine and trace of test_torch_engine.py (synthetic_trace seed 0)
ENGINE = dict(num_slots=4, max_len=64, prefill_chunk=8)
TRACE = dict(vocab_size=256, prompt_lens=(3, 24), gen_lens=(1, 16),
             mean_interarrival=0.7)
# the JAX fast-path tests' engine and mixed trace (slot recycling, a
# gen-at-prefill request)
MIXED_ENGINE = dict(num_slots=2, max_len=32, prefill_chunk=8)
COUNTERS = ("decode_steps", "decode_dispatches", "prefill_chunks",
            "prefill_dispatches", "host_syncs", "generated_tokens",
            "occupancy_sum", "engine_steps", "shed", "quarantined")


def _mixed_trace(vocab, request_cls):
    rng = np.random.RandomState(7)
    lens = [(5, 6), (12, 3), (3, 1), (9, 8)]
    return [request_cls(rid=i, prompt=rng.randint(0, vocab, size=p).astype(
        np.int32), max_new_tokens=g) for i, (p, g) in enumerate(lens)]


@pytest.fixture(scope="module", params=RECIPES)
def pair(request):
    """(JAX QuantizedModel, port model, port params, port cfg)."""
    qm = repro.quantize(ARCH, recipe=request.param)
    cfg = get_config(ARCH)
    model = build_model(cfg)
    return qm, model, from_jax_numpy(jax_to_numpy(qm.params), cfg,
                                     device="cpu"), cfg


@pytest.fixture(scope="module")
def fp32():
    """fp32 smoke weights (the JAX kv8 test's), on both sides."""
    jcfg = jax_get_config("qwen2-0.5b", smoke=True)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    return jm, jp, build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                                    device="cpu"), cfg


def _engine(model, params, cfg, **kw):
    return ServingEngine(model, params, cfg, device="cpu",
                         **{"kv_bits": 8, **kw})


def _assert_same_run(res, eng, jres, jeng):
    assert sorted(res) == sorted(jres)
    for rid in jres:
        assert res[rid].tokens == jres[rid].tokens, rid
        assert res[rid].admitted_at == jres[rid].admitted_at, rid
        assert res[rid].finished_at == jres[rid].finished_at, rid
        assert res[rid].status == jres[rid].status == "ok"
    for k in COUNTERS:
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.mean_occupancy() == jeng.mean_occupancy()


def _assert_same_timeline(fast, slow):
    for rid, r in slow.items():
        assert fast[rid].tokens == r.tokens, rid
        assert fast[rid].admitted_at == r.admitted_at, rid
        assert fast[rid].finished_at == r.finished_at, rid


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("horizon", HORIZONS)
def test_fused_vs_stepwise_parity(pair, horizon):
    """The fast path on synthetic_trace seed 0 equals the JAX fast path
    (tokens, ticks, status, counters, mean occupancy) and the port's own
    stepwise run (tokens and ticks; occupancy)."""
    qm, model, params, cfg = pair
    jeng = JaxServingEngine(qm.model, qm.params, qm.cfg, fast=True, kv_bits=8,
                            decode_horizon=horizon, **ENGINE)
    jres = jeng.run(jax_synthetic_trace(0, 10, **TRACE))
    eng = _engine(model, params, cfg, decode_horizon=horizon, **ENGINE)
    res = eng.run(synthetic_trace(0, 10, **TRACE))
    _assert_same_run(res, eng, jres, jeng)
    slow_eng = _engine(model, params, cfg, fast=False, **ENGINE)
    _assert_same_timeline(res, slow_eng.run(synthetic_trace(0, 10, **TRACE)))
    assert eng.mean_occupancy() == pytest.approx(slow_eng.mean_occupancy())
    assert eng.pool.all_free() and not eng.pool._pending_reset


@pytest.mark.parametrize("horizon", HORIZONS)
def test_kv8_fused_vs_stepwise_parity(fp32, horizon):
    """The JAX kv8 test's setting — fp32 weights, an int8 cache, two slots
    recycled, a request whose only token comes from its prefill — fast
    against the JAX fast path and the port's stepwise path."""
    jm, jp, model, params, cfg = fp32
    jeng = JaxServingEngine(jm, jp, jm.cfg, fast=True, kv_bits=8,
                            decode_horizon=horizon, **MIXED_ENGINE)
    jres = jeng.run(_mixed_trace(cfg.vocab_size, JaxRequest))
    eng = _engine(model, params, cfg, decode_horizon=horizon, **MIXED_ENGINE)
    res = eng.run(_mixed_trace(cfg.vocab_size, Request))
    _assert_same_run(res, eng, jres, jeng)
    slow = _engine(model, params, cfg, fast=False, **MIXED_ENGINE).run(
        _mixed_trace(cfg.vocab_size, Request))
    _assert_same_timeline(res, slow)
    assert eng.pool.all_free()


@pytest.mark.parametrize("mode", ["unfused", "kv_bias_correct"])
def test_fast_routes_match_jax_fast_path(pair, mode, monkeypatch):
    """The other decode routes on the fast path, at horizon 8:
    ``REPRO_FUSED_DECODE=0`` and the V bias correction (the cache's v_err
    leaf), against the JAX fast path on the same config."""
    qm, _, _, _ = pair
    if mode == "unfused":
        monkeypatch.setenv("REPRO_FUSED_DECODE", "0")
    correct = mode == "kv_bias_correct"
    jm = jax_build_model(dataclasses.replace(
        jax_get_config("qwen2-0.5b", smoke=True), kv_bias_correct=correct))
    cfg = dataclasses.replace(get_config(ARCH), kv_bias_correct=correct)
    model = build_model(cfg)
    params = from_jax_numpy(jax_to_numpy(qm.params), cfg, device="cpu")
    jeng = JaxServingEngine(jm, qm.params, jm.cfg, fast=True, kv_bits=8,
                            **ENGINE)
    jres = jeng.run(jax_synthetic_trace(0, 10, **TRACE))
    eng = _engine(model, params, cfg, **ENGINE)
    assert ("v_err" in eng.pool.cache) == correct
    _assert_same_run(eng.run(synthetic_trace(0, 10, **TRACE)), eng, jres,
                     jeng)


# ----------------------------------------------------- dispatches and syncs

def _counting(eng):
    counts = {"decode_horizon": 0, "prefill_multi": 0}
    real = eng._dispatch

    def counted(name, dim, args):
        counts[name] += 1
        return real(name, dim, args)

    eng._dispatch = counted
    return counts


def test_fast_path_dispatch_and_sync_counts(pair):
    """At most ceil(decode tokens / horizon) decode dispatches and ONE
    prefill dispatch for three slots prefilling together; one host sync a
    horizon plus one for the prefill round that finished the prompts."""
    _, model, params, cfg = pair
    H, G = 4, 9  # 1 token from prefill + 8 decode steps
    eng = _engine(model, params, cfg, num_slots=4, max_len=32,
                  prefill_chunk=8, decode_horizon=H)
    counts = _counting(eng)
    res = eng.run([Request(rid=i, prompt=[1 + i] * 8, max_new_tokens=G)
                   for i in range(3)])
    assert sorted(res) == [0, 1, 2]
    assert counts["prefill_multi"] == 1
    assert counts["decode_horizon"] <= math.ceil((G - 1) / H)
    assert eng.stats["decode_dispatches"] == counts["decode_horizon"]
    assert eng.stats["prefill_dispatches"] == counts["prefill_multi"]
    assert eng.stats["decode_steps"] == G - 1
    assert eng.stats["host_syncs"] == counts["decode_horizon"] + 1


def test_host_sync_reduction_at_horizon_8(pair):
    """>= 4x fewer host syncs per generated token than the stepwise path
    at horizon 8 on a decode-heavy batch, with the same tokens."""
    _, model, params, cfg = pair
    trace = [Request(rid=i, prompt=[3 + i] * 6, max_new_tokens=17)
             for i in range(4)]

    def run(fast):
        eng = _engine(model, params, cfg, num_slots=4, max_len=32,
                      prefill_chunk=8, decode_horizon=8, fast=fast)
        return eng.run([dataclasses.replace(r) for r in trace]), eng

    slow_res, slow = run(False)
    fast_res, fast = run(True)
    assert {r: v.tokens for r, v in fast_res.items()} == \
           {r: v.tokens for r, v in slow_res.items()}
    assert slow.syncs_per_token() >= 4 * fast.syncs_per_token(), (
        slow.syncs_per_token(), fast.syncs_per_token())


def test_horizon_capped_by_scheduled_arrival(pair):
    """peek_arrival feeds the adaptive horizon: a pending arrival does not
    wait behind a long horizon while a slot is free."""
    _, model, params, cfg = pair
    trace = [Request(rid=0, prompt=[1] * 4, max_new_tokens=20, arrival=0.0),
             Request(rid=1, prompt=[2] * 4, max_new_tokens=4, arrival=2.0)]
    eng = _engine(model, params, cfg, num_slots=2, max_len=32,
                  prefill_chunk=8, decode_horizon=16)
    res = eng.run(trace)
    assert res[1].admitted_at == 2.0
    ref = _engine(model, params, cfg, num_slots=2, max_len=32,
                  prefill_chunk=8, fast=False).run(
        [dataclasses.replace(r) for r in trace])
    assert res[1].tokens == ref[1].tokens
    assert res[1].admitted_at == ref[1].admitted_at


@pytest.mark.parametrize("horizon,want", [
    (1, [1]), (3, [1, 2]), (8, [1, 2, 4, 8]), (12, [1, 2, 4, 8])])
def test_warmup_and_dispatch_shapes(pair, horizon, want):
    """One prefill shape and every power-of-two horizon up to the bound;
    the shapes a loop dispatches are closed under warmup's."""
    _, model, params, cfg = pair
    eng = _engine(model, params, cfg, decode_horizon=horizon, **ENGINE)
    assert eng.warmup_shapes() == eng.dispatch_shapes() == (
        {("prefill_multi", 4)} | {("decode_horizon", k) for k in want})
    slow = _engine(model, params, cfg, fast=False, **ENGINE)
    assert slow.warmup_shapes() == {("prefill", 1), ("decode", 1)}
    with pytest.raises(ValueError, match="decode_horizon"):
        _engine(model, params, cfg, decode_horizon=0)


# ----------------------------------------------------------- warmup, leaves

def _addresses(eng):
    return {k: v.data_ptr() for k, v in eng.pool.cache.items()}


def test_warmup_leaves_engine_state_bit_identical(fp32):
    """warmup() restores the pool's bytes and bookkeeping, stats, clock and
    unclaimed results, and every cache leaf keeps its address across it and
    across a whole fast run (what a captured graph relies on)."""
    _, _, model, params, cfg = fp32
    eng = _engine(model, params, cfg, **MIXED_ENGINE)
    eng.submit(Request(rid=0, prompt=[5] * 9, max_new_tokens=4))
    eng.submit(Request(rid=1, prompt=[6] * 9, max_new_tokens=4))
    while eng._inflight or eng.scheduler.pending():
        eng.step()
    addresses = _addresses(eng)
    before_cache = {k: v.clone() for k, v in eng.pool.cache.items()}
    before = dict(stats=dict(eng.stats), clock=eng.clock,
                  free=set(eng.pool._free),
                  allocated=set(eng.pool._allocated),
                  pending=set(eng.pool._pending_reset),
                  order=list(eng.scheduler.admitted_order),
                  results={r: res.tokens for r, res in eng.results.items()})

    ran = eng.warmup()

    for k, v in eng.pool.cache.items():
        assert torch.equal(v, before_cache[k]), k
    assert _addresses(eng) == addresses
    assert dict(eng.stats) == before["stats"]
    assert eng.clock == before["clock"]
    assert set(eng.pool._free) == before["free"]
    assert set(eng.pool._allocated) == before["allocated"]
    assert set(eng.pool._pending_reset) == before["pending"]
    assert list(eng.scheduler.admitted_order) == before["order"]
    assert {r: res.tokens for r, res in eng.results.items()} \
        == before["results"]
    # prefill: the width run + one a horizon; decode: 1 + 2 + 4 + 8 steps
    # (the CPU captures nothing, so runs no masked dispatch)
    assert (ran["prefill_dispatches"], ran["decode_steps"]) == (5, 15)

    # and the engine still serves, without rebinding a leaf
    res = eng.run([Request(rid=2, prompt=[7] * 9, max_new_tokens=4)])
    assert res[2].status == "ok" and len(res[2].tokens) == 4
    assert _addresses(eng) == addresses


def test_warmup_refuses_a_busy_engine(pair):
    _, model, params, cfg = pair
    eng = _engine(model, params, cfg, **ENGINE)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="idle engine"):
        eng.warmup()


def test_from_quantized_serves_the_quantized_model():
    qm = repro_torch.quantize(ARCH, recipe="serve-w8a8-kv8", device="cpu")
    eng = ServingEngine.from_quantized(qm, device="cpu", **MIXED_ENGINE)
    assert eng.params is qm.params and eng.fast and eng.graphs is None
    res = eng.run(_mixed_trace(qm.cfg.vocab_size, Request))
    assert [len(res[i].tokens) for i in range(4)] == [6, 3, 1, 8]


# ------------------------------------------------ pool, scheduler, monitor

def test_cache_pool_deferred_reset(fp32):
    """allocate(reset=False) leaves the stale bookkeeping and tracks the
    pending reset; a release before it commits repairs the slot in place."""
    _, _, model, _, _ = fp32
    pool = CachePool(model, 2, 8, device="cpu", kv_bits=8)
    kpos = pool.cache["kpos"]
    slot = pool.allocate()
    pool.cache["pos"][slot] = 5
    pool.cache["kpos"][slot, :5] = torch.arange(5)
    pool.release(slot)
    assert pool.allocate(reset=False) == slot
    assert int(pool.cache["pos"][slot]) == 5 and slot in pool._pending_reset
    pool.check_invariants()
    pool.release(slot)                       # repairs the pending reset
    assert int(pool.cache["pos"][slot]) == 0
    assert bool((pool.cache["kpos"][slot] == -1).all())
    assert not pool._pending_reset and pool.cache["kpos"] is kpos
    slot = pool.allocate(reset=False)
    pool.note_reset_committed(slot)
    assert not pool._pending_reset
    pool.release(slot)
    pool.check_invariants()


def test_scheduler_peek_arrival():
    from repro_torch.serving import FIFOScheduler

    s = FIFOScheduler()
    assert s.peek_arrival() is None
    s.submit(Request(rid=0, prompt=[1], max_new_tokens=1, arrival=2.5))
    s.submit(Request(rid=1, prompt=[1], max_new_tokens=1, arrival=1.0))
    assert s.peek_arrival() == 2.5 and s.pending() == 2


class _AlwaysSlow:
    threshold = 1.5

    def observe(self, step, dt):
        return True


def test_straggler_monitor_counts_slow_steps(pair):
    _, model, params, cfg = pair
    eng = _engine(model, params, cfg, straggler=_AlwaysSlow(), **ENGINE)
    assert eng.stats["straggler_threshold"] == 1.5
    eng.run([Request(rid=0, prompt=[1] * 8, max_new_tokens=4)])
    # one observation a step() call; engine_steps counts horizon ticks
    assert 0 < eng.stats["straggler_steps"] <= eng.stats["engine_steps"]

    mon = StragglerMonitor(threshold=2.0, warmup_steps=1)
    assert not mon.observe(0, 1.0)       # warmup
    assert not mon.observe(1, 1.0)       # seeds the EMA
    assert mon.observe(2, 10.0)          # 10x the EMA
    assert not mon.observe(3, 1.0)       # the slow step did not poison it
    assert mon.events == [(2, 10.0, 1.0)]


def test_add_launches_adds_and_takes_back():
    before = dispatch.launch_counts()
    dispatch.add_launches({"fused_decode": 3})
    dispatch.add_launches({"fused_decode": -3})
    assert dispatch.launch_counts() == before


# ------------------------------------------------------------------ serve

@pytest.mark.parametrize("reference", [False, True])
def test_serve_fast_and_reference_on_cpu(reference, capsys):
    run = repro_torch.serve(repro_torch.ServeConfig(
        smoke=True, device="cpu", slots=2, trace=3, prompt_len=10,
        gen_len=6, prefill_chunk=4, reference=reference, warmup=True))
    out = capsys.readouterr().out
    assert all(r.status == "ok" for r in run.results.values())
    path = "stepwise" if reference else "fast (decode horizon 8)"
    assert run.path == path and f"tok/s, {path} path)" in out
    assert "warmup: ran the serving shapes in" in out
    assert run.warmup is not None and run.warmup["prefill_dispatches"] > 0
    assert (run.stats["decode_dispatches"] < run.stats["decode_steps"]) \
        != reference


def test_serve_paths_serve_the_same_tokens():
    config = repro_torch.ServeConfig(smoke=True, device="cpu", slots=2,
                                     trace=4, prompt_len=10, gen_len=8,
                                     prefill_chunk=4, decode_horizon=4)
    fast = repro_torch.serve(config)
    slow = repro_torch.serve(dataclasses.replace(config, reference=True))
    _assert_same_timeline(fast.results, slow.results)


def test_serve_parser_takes_the_fast_path_flags():
    from repro_torch.launch.serve_config import (
        ServeConfig,
        ServeConfigError,
        build_parser,
    )

    default = ServeConfig.from_args(build_parser().parse_args([]))
    assert (default.decode_horizon, default.reference, default.warmup) == \
           (8, False, False)
    cfg = ServeConfig.from_args(build_parser().parse_args(
        ["--decode-horizon", "4", "--reference", "--warmup"]))
    assert (cfg.decode_horizon, cfg.reference, cfg.warmup) == (4, True, True)
    with pytest.raises(ServeConfigError, match="decode_horizon"):
        ServeConfig(decode_horizon=0).validate()
