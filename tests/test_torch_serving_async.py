"""The async streaming front-end of the port (``repro_torch.serving.server``
/ ``client`` / ``loadgen``) over the port's engine: the nine tests of
``tests/test_serving_async.py`` restated — token streaming parity, timeouts
wired to engine deadlines, retry round trips against a real bounded queue,
the circuit breaker, the shedding ladder, graceful drain, whole-run
determinism, the straggler threshold — plus the idle step, and one seeded
open-loop overload run through both packages' front-ends over both
packages' engines on the same fp32 smoke weights.

Everything runs on the engine-tick clock (no wall-clock timer anywhere in
the server), so every assertion here is exact.
"""
import asyncio
import dataclasses

import numpy as np
import pytest

from _torch_port import serving_pair

from repro_torch.runtime import StragglerMonitor
from repro_torch.serving import (
    AsyncClient,
    AsyncServer,
    CircuitBreaker,
    CircuitOpen,
    QueueFull,
    Request,
    RetryPolicy,
    ServerOverloaded,
    ServingEngine,
    ShedPolicy,
    open_loop_trace,
    run_open_loop,
)


@pytest.fixture(scope="module")
def pair():
    """((JAX model, params, cfg), (port model, params, cfg)): the qwen2
    smoke model at fp32, JAX's ``PRNGKey(0)`` init carried across."""
    jax_side, port_side, _ = serving_pair("fp32")
    return jax_side, port_side


@pytest.fixture(scope="module")
def fp32_setup(pair):
    return pair[1]


def _engine(model, params, cfg, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("decode_horizon", 4)
    return ServingEngine(model, params, cfg, device="cpu", **kw)


def _req(rid, p, g, **kw):
    rng = np.random.RandomState(100 + rid)
    return Request(rid=rid, prompt=rng.randint(0, 64, size=p).astype(np.int32),
                   max_new_tokens=g, **kw)


# ------------------------------------------------------------ breaker (unit)

def test_circuit_breaker_lifecycle():
    br = CircuitBreaker(window=8, failure_threshold=0.5, min_volume=4,
                        cooldown=10.0)
    assert br.state == "closed"
    for t in range(3):
        assert br.allow(t)
        br.record(False, t)
    assert br.state == "closed"
    br.record(False, 3.0)
    assert br.state == "open" and br.opens == 1
    assert not br.allow(4.0) and not br.allow(12.9)
    assert br.allow(13.0) and br.state == "half_open"
    br.record(False, 13.0)
    assert br.state == "open" and br.opens == 2
    assert br.allow(23.0) and br.state == "half_open"
    br.record(True, 23.0)
    assert br.state == "closed"
    br.record(False, 24.0)
    assert br.state == "closed"
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0.0)
    with pytest.raises(ValueError):
        ShedPolicy(shed_pressure=0.9, tighten_pressure=0.5)


def test_breaker_trips_on_real_queue_rejections(fp32_setup):
    model, params, cfg = fp32_setup
    engine = _engine(model, params, cfg, max_queue=1)
    server = AsyncServer(engine,
                         breaker=CircuitBreaker(window=8,
                                                failure_threshold=0.5,
                                                min_volume=4, cooldown=16.0),
                         shed=ShedPolicy(refuse_pressure=10.0,
                                         shed_pressure=9.0,
                                         tighten_pressure=9.5))
    server.submit(_req(0, 4, 2))
    rejected = 0
    with pytest.raises(CircuitOpen):
        for rid in range(1, 20):
            try:
                server.submit(_req(rid, 4, 2))
            except QueueFull:
                rejected += 1
    assert rejected >= 3
    assert server.breaker.state == "open" and server.breaker.opens == 1
    before = server.stats["shed_queue"]
    with pytest.raises(CircuitOpen):
        server.submit(_req(99, 4, 2))
    assert server.stats["shed_queue"] == before


# ------------------------------------------------------------ shedding ladder

def test_priority_shedding_ladder(fp32_setup):
    model, params, cfg = fp32_setup
    engine = _engine(model, params, cfg, max_queue=4)
    server = AsyncServer(engine, breaker=CircuitBreaker(min_volume=100),
                         shed=ShedPolicy(shed_pressure=0.5,
                                         tighten_pressure=0.75,
                                         refuse_pressure=1.0,
                                         tightened_slack=64.0))
    server.submit(_req(0, 4, 2))
    server.submit(_req(1, 4, 2))
    with pytest.raises(ServerOverloaded):
        server.submit(_req(2, 4, 2, priority=0))
    assert server.stats["shed_priority"] == 1
    server.submit(_req(3, 4, 2, priority=1))
    server.submit(_req(4, 4, 2, priority=1))
    assert server.stats["deadlines_tightened"] == 1
    queued = {r.rid: r for r in engine.scheduler._queue}
    assert queued[4].deadline == engine.clock + 64.0
    assert queued[3].deadline is None
    with pytest.raises(ServerOverloaded):
        server.submit(_req(5, 4, 2, priority=5))
    assert server.stats["shed_refused"] == 1


# ----------------------------------------------------- streaming + timeouts

def test_streaming_matches_batch_engine(fp32_setup):
    model, params, cfg = fp32_setup
    trace = open_loop_trace(3, 8, 0.5, vocab_size=cfg.vocab_size,
                            prompt_lens=(4, 12), gen_lens=(4, 12))
    ref = _engine(model, params, cfg).run(
        [dataclasses.replace(r) for r in trace])
    engine = _engine(model, params, cfg)
    server = AsyncServer(engine)
    client = AsyncClient(server, RetryPolicy(), seed=0)
    outcomes = asyncio.run(run_open_loop(
        server, client, [dataclasses.replace(r) for r in trace]))
    assert len(outcomes) == len(trace)
    for o in outcomes:
        assert o.ok
        assert list(o.tokens) == list(ref[o.rid].tokens)
        assert o.token_ticks == sorted(o.token_ticks)
        assert o.ttft is not None and o.ttft >= 0
        assert o.finished_tick >= o.token_ticks[-1]


def test_timeout_wires_to_engine_deadline(fp32_setup):
    model, params, cfg = fp32_setup
    engine = _engine(model, params, cfg)
    server = AsyncServer(engine)
    client = AsyncClient(server, RetryPolicy(max_attempts=4), seed=0)

    async def drive():
        server.start()
        out = await client.run(_req(0, 8, 20), timeout=6.0)
        await server.aclose()
        return out

    out = asyncio.run(drive())
    assert out.status == "expired"
    assert out.attempts == 1
    assert 0 < len(out.tokens) < 20
    assert engine.results[0].status == "expired"
    assert list(engine.results[0].tokens) == list(out.tokens)


def test_queuefull_retry_roundtrip_real_engine(fp32_setup):
    model, params, cfg = fp32_setup
    engine = _engine(model, params, cfg, max_queue=1)
    server = AsyncServer(engine, breaker=CircuitBreaker(min_volume=1000),
                         shed=ShedPolicy(shed_pressure=8.0,
                                         tighten_pressure=9.0,
                                         refuse_pressure=10.0))
    client = AsyncClient(server, RetryPolicy(max_attempts=10,
                                             base_backoff=2.0), seed=1)
    trace = [_req(i, 4, 4) for i in range(5)]
    outcomes = asyncio.run(run_open_loop(server, client, trace))
    assert all(o.ok for o in outcomes)
    assert max(o.attempts for o in outcomes) > 1
    assert server.stats["shed_queue"] > 0


# ----------------------------------------------------------- drain + determinism

def test_drain_finishes_inflight_rejects_new(fp32_setup):
    model, params, cfg = fp32_setup
    engine = _engine(model, params, cfg)
    server = AsyncServer(engine)

    async def drive():
        server.start()
        s1 = server.submit(_req(0, 8, 6))
        await server.wait_ticks(1)
        server.drain()
        with pytest.raises(QueueFull):
            server.submit(_req(1, 4, 2))
        r1 = await s1.drain()
        await server.aclose()
        return r1

    r1 = asyncio.run(drive())
    assert r1.status == "ok" and len(r1.tokens) == 6
    assert engine.draining


def _overload_run(engine, *, seed=2, trace_seed=7, n=12, qps=1.5,
                  Request_=None, AsyncServer_=AsyncServer,
                  AsyncClient_=AsyncClient, RetryPolicy_=RetryPolicy,
                  CircuitBreaker_=CircuitBreaker, run_open_loop_=run_open_loop,
                  open_loop_trace_=open_loop_trace, vocab_size=256):
    """One seeded open-loop overload run (2 priority classes, max_queue 4,
    a breaker that opens); returns (per-rid outcome tuples, admission
    stats, breaker opens). The keyword arguments name the classes of the
    package the run goes through."""
    trace = open_loop_trace_(trace_seed, n, qps, vocab_size=vocab_size,
                             prompt_lens=(4, 12), gen_lens=(4, 12),
                             priority_levels=2)
    server = AsyncServer_(engine,
                          breaker=CircuitBreaker_(window=8,
                                                  failure_threshold=0.5,
                                                  min_volume=4, cooldown=8.0))
    client = AsyncClient_(server, RetryPolicy_(max_attempts=3), seed=seed)
    outcomes = asyncio.run(run_open_loop_(server, client, trace))
    stats = {k: v for k, v in server.stats.items() if k != "results"}
    return ([(o.rid, o.status, o.attempts, tuple(o.tokens),
              tuple(o.token_ticks), o.first_token_tick, o.finished_tick)
             for o in outcomes], stats, server.breaker.opens,
            dict(server.stats["results"]))


def test_open_loop_run_is_deterministic(fp32_setup):
    model, params, cfg = fp32_setup

    def run_once():
        return _overload_run(_engine(model, params, cfg, max_queue=4))

    assert run_once() == run_once()


# ------------------------------------------------------- straggler threshold

def test_straggler_threshold_surfaced_in_stats(fp32_setup):
    model, params, cfg = fp32_setup
    eng = _engine(model, params, cfg,
                  straggler=StragglerMonitor(threshold=3.5))
    assert eng.stats["straggler_threshold"] == 3.5
    assert _engine(model, params, cfg).stats["straggler_threshold"] == 2.0


# ----------------------------------------------------------------- idle step

@pytest.mark.parametrize("fast", [True, False], ids=["fast", "stepwise"])
def test_idle_step_moves_the_clock_and_launches_nothing(fp32_setup, fast):
    """The server steps the engine while only sleepers remain: with nothing
    in flight a step advances the clock one tick and dispatches nothing
    (the stats' dispatch counters stay; on the card, where a dispatch
    replays a graph, ``test_torch_cuda.py`` checks that no kernel is
    launched); a sleeper is released at its tick."""
    model, params, cfg = fp32_setup
    engine = _engine(model, params, cfg, fast=fast)
    server = AsyncServer(engine)
    keys = ("decode_dispatches", "prefill_dispatches", "decode_steps",
            "generated_tokens")
    before = {k: engine.stats[k] for k in keys}

    async def drive():
        server.start()
        await server.wait_until(5.0)
        clock = engine.clock
        await server.aclose()
        return clock

    assert asyncio.run(drive()) == 5.0
    assert server.steps == 5 and engine.stats["engine_steps"] == 5
    assert {k: engine.stats[k] for k in keys} == before


def test_warmup_passes_a_bounded_queue(fp32_setup):
    """``warmup`` runs one throwaway request a slot through the serving
    loop: a queue bounded below the slot count (``--max-queue 1`` with 2
    slots, the async launcher's overload setting) takes them, and keeps
    its bound after."""
    model, params, cfg = fp32_setup
    engine = _engine(model, params, cfg, max_queue=1)
    warm = engine.warmup()
    assert warm["prefill_dispatches"] > 0
    assert engine.scheduler.max_queue == 1 and engine.clock == 0.0
    engine.submit(_req(0, 4, 2))
    with pytest.raises(QueueFull):
        engine.submit(_req(1, 4, 2))


# ---------------------------------------------------- across the packages

def test_overload_run_matches_the_jax_front_end(pair):
    """One seeded open-loop overload trace through the JAX ``AsyncServer`` /
    ``AsyncClient`` over the JAX engine and through the port's over the
    port's engine (the same fp32 smoke weights): the admission counters,
    the breaker's opens, the terminal statuses, and each rid's status,
    attempts, tokens, token ticks, first-token and finish ticks equal."""
    import repro.serving as js

    (jm, jp, jcfg), (tm, tp, tcfg) = pair
    jax_engine = js.ServingEngine(jm, jp, jcfg, num_slots=2, max_len=32,
                                  prefill_chunk=8, decode_horizon=4,
                                  max_queue=4)
    want = _overload_run(jax_engine, AsyncServer_=js.AsyncServer,
                         AsyncClient_=js.AsyncClient,
                         RetryPolicy_=js.RetryPolicy,
                         CircuitBreaker_=js.CircuitBreaker,
                         run_open_loop_=js.run_open_loop,
                         open_loop_trace_=js.open_loop_trace)
    got = _overload_run(_engine(tm, tp, tcfg, max_queue=4))
    outcomes, stats, opens, results = got
    assert stats == want[1] and opens == want[2] and results == want[3]
    assert outcomes == want[0]
    # the run exercised what it claims to: sheds, retries, a breaker trip
    assert stats["shed_priority"] + stats["shed_queue"] > 0 and opens >= 1
    assert max(o[2] for o in outcomes) > 1
