"""The port's fault tolerance against the JAX engine's: the error taxonomy,
deadlines, cancellation, preemption and resume, drain, quarantine, warmup
isolation, the streaming callbacks, ``REPRO_POOL_CHECK`` auditing, and the
launcher's new fields (``--page-size``, ``--num-pages``,
``--no-prefix-reuse``, ``--deadline``, ``--straggler-threshold``).

Both engines serve the same requests over the JAX package's fp32 smoke
weights carried across; statuses, tokens, ticks and counters must be
equal, contiguous and paged, fast and stepwise. Everything runs on the
port's plain versions on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.launch.serve_config import ServeConfig as JaxServeConfig
from repro.launch.serve_config import ServeConfigError as JaxServeConfigError
from repro.launch.serve_config import build_parser as jax_build_parser
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import errors as jax_errors
from repro.serving import synthetic_trace as jax_trace

from repro_torch.launch import serve
from repro_torch.launch.serve_config import ServeConfig, ServeConfigError
from repro_torch.launch.serve_config import build_parser
from repro_torch.runtime import StragglerMonitor
from repro_torch.serving import (
    PoolExhausted,
    QueueFull,
    Request,
    RequestTooLarge,
    ServingEngine,
    ServingError,
    errors,
)
from repro_torch.serving import synthetic_trace as port_trace

from _torch_port import serving_pair

# the JAX fault tests' engine
ENGINE = dict(num_slots=2, max_len=32, prefill_chunk=8, decode_horizon=4)
COUNTERS = ("decode_steps", "prefill_chunks", "generated_tokens",
            "engine_steps", "preempted", "resumed", "shed", "cancelled",
            "expired", "quarantined")


@pytest.fixture(scope="module")
def fp32():
    return serving_pair("fp32")


def _req(cls, rid, p, g, **kw):
    """The JAX fault tests' request: prompt from RandomState(100 + rid)."""
    rng = np.random.RandomState(100 + rid)
    return cls(rid=rid, prompt=rng.randint(0, 64, size=p).astype(np.int32),
               max_new_tokens=g, **kw)


def _engines(fp32, **kw):
    """(port engine, JAX engine) of ``ENGINE`` updated by ``kw``."""
    (jm, jp, jcfg), (model, params, cfg), kv_bits = fp32
    kw = {**ENGINE, **kw}
    return (ServingEngine(model, params, cfg, device="cpu", kv_bits=kv_bits,
                          **kw),
            JaxServingEngine(jm, jp, jcfg, **kw))


def _same(res, jres):
    assert sorted(res) == sorted(jres)
    for rid, want in jres.items():
        got = res[rid]
        assert (got.status, got.tokens, got.admitted_at, got.finished_at) == (
            want.status, [int(t) for t in want.tokens], want.admitted_at,
            want.finished_at), rid


def _same_stats(eng, jeng):
    for k in COUNTERS:
        assert eng.stats[k] == jeng.stats[k], k


# ------------------------------------------------------------ the taxonomy

def test_taxonomy_matches_jax():
    assert errors.taxonomy() == jax_errors.taxonomy()
    assert list(errors.taxonomy()) == list(jax_errors.taxonomy())
    for name in jax_errors.taxonomy():
        port_cls, jax_cls = getattr(errors, name), getattr(jax_errors, name)
        assert ([c.__name__ for c in port_cls.__mro__]
                == [c.__name__ for c in jax_cls.__mro__]), name


def test_error_taxonomy_keeps_legacy_handlers(fp32):
    """``RequestTooLarge`` IS-A ValueError, ``QueueFull`` and
    ``PoolExhausted`` ARE RuntimeErrors, and ``ServingError`` catches all."""
    eng, _ = _engines(fp32, max_queue=1)
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=[1] * 30, max_new_tokens=8))
    eng.submit(_req(Request, 1, 8, 4))
    with pytest.raises(RuntimeError) as e:
        eng.submit(_req(Request, 2, 8, 4))
    assert isinstance(e.value, QueueFull) and e.value.retryable
    assert eng.stats["shed"] == 1
    assert issubclass(PoolExhausted, RuntimeError) and PoolExhausted.retryable
    assert not RequestTooLarge.retryable
    for name in errors.taxonomy():
        assert issubclass(getattr(errors, name), ServingError)


# --------------------------------------------------------------- deadlines

@pytest.mark.parametrize("paged", [False, True])
def test_deadline_is_tick_exact(fp32, paged):
    """A request whose deadline falls mid-decode expires at JAX's tick with
    JAX's partial tokens, fast and stepwise; the other runs to the end."""
    kw = {"page_size": 8} if paged else {}
    spec = lambda cls: [_req(cls, 0, 8, 12, deadline=5.0), _req(cls, 1, 8, 12)]
    jeng = _engines(fp32, **kw)[1]
    jres = jeng.run(spec(JaxRequest))
    for fast in (True, False):
        eng = _engines(fp32, fast=fast, **kw)[0]
        res = eng.run(spec(Request))
        _same(res, jres)
        assert res[0].status == "expired" and len(res[0].tokens) < 12
        assert res[1].status == "ok" and len(res[1].tokens) == 12
        assert eng.stats["expired"] == jeng.stats["expired"] == 1


@pytest.mark.parametrize("paged", [False, True])
def test_deadline_trace_matches_jax(fp32, paged):
    """``synthetic_trace`` with ``deadline_slack``: JAX's statuses, tokens
    and ticks, fast and stepwise, queued expiries included."""
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8, decode_horizon=8)
    if paged:
        kw.update(page_size=8, num_pages=8)
    tr = dict(vocab_size=256, prompt_lens=(4, 16), gen_lens=(4, 16),
              mean_interarrival=1.0, deadline_slack=(4.0, 24.0))
    jeng = _engines(fp32, **kw)[1]
    jres = jeng.run(jax_trace(1, 12, **tr))
    assert {r.status for r in jres.values()} == {"ok", "expired"}
    for fast in (True, False):
        eng = _engines(fp32, fast=fast, **kw)[0]
        _same(eng.run(port_trace(1, 12, **tr)), jres)
        assert eng.stats["expired"] == jeng.stats["expired"]


def test_deadline_expired_in_queue_is_shed(fp32):
    eng, jeng = _engines(fp32, num_slots=1)
    for e, cls in ((eng, Request), (jeng, JaxRequest)):
        e.submit(_req(cls, 0, 8, 16))
        e.submit(_req(cls, 1, 8, 12, deadline=3.0))
    res, jres = eng.run(), jeng.run()
    _same(res, jres)
    assert res[1].status == "expired" and res[1].tokens == []
    _same_stats(eng, jeng)


def test_deadline_must_follow_arrival():
    with pytest.raises(ValueError, match="deadline"):
        Request(rid=0, prompt=[1, 2], max_new_tokens=2, arrival=5.0,
                deadline=5.0)


# ------------------------------------------------------------ cancellation

@pytest.mark.parametrize("paged", [False, True])
def test_cancel_queued_inflight_parked_and_unknown(fp32, paged):
    """A queued request is dropped at once, an in-flight one at the next
    boundary, a parked (preempted) one at admission; an unknown rid is
    refused — each as in JAX."""
    kw = {"page_size": 8} if paged else {}
    outs = []
    for e, cls in zip(_engines(fp32, **kw), (Request, JaxRequest)):
        for r in (_req(cls, 0, 8, 8), _req(cls, 1, 9, 8), _req(cls, 2, 8, 8)):
            e.submit(r)
        log = [e.cancel(2), e.results[2].status, e.results[2].tokens]
        e.step()
        e.step()
        log.append(e.cancel(0))
        e.preempt(1)
        log += [e.cancel(1), e.cancel(999)]
        res = e.run()
        log += [(r.status, [int(t) for t in r.tokens], r.finished_at)
                for _, r in sorted(res.items())]
        log += [e.stats[k] for k in COUNTERS]
        outs.append(log)
    assert outs[0] == outs[1]
    assert outs[0][3:6] == [True, True, False]


# -------------------------------------------------------------- preemption

def test_manual_preempt_resume_is_bit_identical(fp32):
    """Preempting a request mid-decode (its covered prefix published, its
    pages released) and resuming it gives the uncontended run's tokens, as
    in JAX; the result keeps the original prompt length."""
    trace = lambda cls: [_req(cls, 0, 9, 10), _req(cls, 1, 5, 6)]
    base = _engines(fp32, page_size=8)[0].run(trace(Request))
    outs = []
    for e, cls in zip(_engines(fp32, page_size=8), (Request, JaxRequest)):
        for r in trace(cls):
            e.submit(r)
        while not (0 in e._inflight and e._inflight[0].generated):
            e.step()
        e.preempt(0)
        assert 0 not in e._inflight and len(e._parked) == 1
        res = e.run()
        with pytest.raises(KeyError):
            e.preempt(123)
        outs.append(({rid: (r.status, [int(t) for t in r.tokens],
                            r.finished_at, r.prompt_len)
                      for rid, r in res.items()},
                     [e.stats[k] for k in COUNTERS], e.prefix_index.hits))
    assert outs[0] == outs[1]
    for rid in (0, 1):
        assert outs[0][0][rid][1] == base[rid].tokens
    assert outs[0][0][0][3] == 9


@pytest.mark.parametrize("fast", [True, False])
def test_starved_pool_preempts_jax_victims_in_order(fp32, fast):
    """Page exhaustion under a higher-priority arrival preempts the same
    victims in the same order as JAX's; every request still finishes with
    the full pool's tokens."""
    trace = lambda cls: [_req(cls, 0, 9, 12, priority=0),
                         _req(cls, 1, 9, 12, priority=0),
                         _req(cls, 2, 9, 12, priority=1, arrival=2.0),
                         _req(cls, 3, 12, 10, priority=2, arrival=4.0)]
    kw = dict(page_size=8, num_slots=3, fast=fast)
    base = _engines(fp32, **kw)[0].run(trace(Request))
    eng, jeng = _engines(fp32, num_pages=8, **kw)
    order = {}
    for e in (eng, jeng):
        log = order[id(e)] = []
        inner = e._preempt_one

        def record(fl, inner=inner, log=log, e=e):
            log.append((fl.req.rid, e.clock))
            inner(fl)
        e._preempt_one = record
    res, jres = eng.run(trace(Request)), jeng.run(trace(JaxRequest))
    _same(res, jres)
    _same_stats(eng, jeng)
    assert order[id(eng)] == order[id(jeng)] and len(order[id(eng)]) >= 2
    assert eng.stats["resumed"] == eng.stats["preempted"]
    for rid, r in base.items():
        assert res[rid].status == "ok" and res[rid].tokens == r.tokens
    eng.check_invariants()


def test_preempt_refuses_a_request_that_cannot_resume(fp32):
    """A request whose resume prompt (prompt + generated) would outgrow the
    ring after chunk padding is not preemptible."""
    eng = _engines(fp32, max_len=10, page_size=8, decode_horizon=1)[0]
    eng.submit(_req(Request, 0, 8, 3))
    while not (0 in eng._inflight and eng._inflight[0].generated):
        eng.step()
    with pytest.raises(ValueError, match="resum"):
        eng.preempt(0)


# ------------------------------------------------------- drain, quarantine

def test_drain_stops_admission_but_finishes_inflight(fp32):
    outs = []
    for e, cls in zip(_engines(fp32, num_slots=1), (Request, JaxRequest)):
        e.submit(_req(cls, 0, 8, 6))
        e.submit(_req(cls, 1, 8, 6))
        e.step()
        e.request_drain()
        assert e.draining
        with pytest.raises(QueueFull if cls is Request
                           else jax_errors.QueueFull):
            e.submit(_req(cls, 2, 8, 6))
        res = e.run()
        outs.append(({rid: [int(t) for t in r.tokens]
                      for rid, r in res.items()},
                     e.scheduler.pending(), e.stats["shed"]))
    assert outs[0] == outs[1]
    assert list(outs[0][0]) == [0] and outs[0][1] == 1


@pytest.mark.parametrize("paged", [False, True])
def test_inject_bad_quarantines_without_touching_peers(fp32, paged):
    kw = {"page_size": 8} if paged else {}
    trace = lambda cls: [_req(cls, 0, 8, 6), _req(cls, 1, 8, 6)]
    base = _engines(fp32, **kw)[0].run(trace(Request))
    for fast in (True, False):
        eng, jeng = _engines(fp32, fast=fast, **kw)
        for e, cls in ((eng, Request), (jeng, JaxRequest)):
            for r in trace(cls):
                e.submit(r)
            e.inject_bad(0)
        res, jres = eng.run(), jeng.run()
        _same(res, jres)
        assert res[0].status == "quarantined"
        assert eng.stats["quarantined"] == 1
        assert res[1].tokens == base[1].tokens


def test_nonfinite_logits_quarantine_the_row(fp32, monkeypatch):
    """A real non-finite logit (not an injected one) quarantines its row at
    the next sync; the other row keeps its tokens."""
    eng = _engines(fp32, page_size=8)[0]
    base = _engines(fp32, page_size=8)[0].run(
        [_req(Request, 0, 8, 6), _req(Request, 1, 8, 6)])
    decode = eng.model.decode_step

    def poisoned(params, tokens, cache):
        logits, new = decode(params, tokens, cache)
        if eng.stats["decode_steps"] >= 1:
            logits = logits.clone()
            logits[0, 0] = float("nan")
        return logits, new
    monkeypatch.setattr(eng.model, "decode_step", poisoned)
    res = eng.run([_req(Request, 0, 8, 6), _req(Request, 1, 8, 6)])
    assert res[0].status == "quarantined"
    assert res[0].tokens == base[0].tokens[:len(res[0].tokens)]
    assert res[1].status == "ok" and res[1].tokens == base[1].tokens


# ------------------------------------------------------- warmup isolation

@pytest.mark.parametrize("paged", [False, True])
def test_warmup_leaves_engine_state_bit_identical(fp32, paged):
    """Warmup restores the pool (every leaf's bytes at its address; paged,
    the free heap in its order, refcounts, slot pages, ``cow_copies``), the
    prefix index, stats, clock and unclaimed results; the engine serves
    correctly afterwards."""
    eng = _engines(fp32, **({"page_size": 8} if paged else {}))[0]
    eng.submit(_req(Request, 0, 9, 4))
    eng.submit(_req(Request, 1, 9, 4))
    while eng._inflight or eng.scheduler.pending():
        eng.step()
    before_cache = {k: (v.data_ptr(), v.clone()) for k, v in eng.pool.cache.items()}
    stores = ({k: v.data_ptr() for k, v in eng.pool.storage.items()}
              if paged else {})
    before = dict(stats=dict(eng.stats), clock=eng.clock,
                  free=set(eng.pool._free), alloc=set(eng.pool._allocated),
                  results={r: v.tokens for r, v in eng.results.items()})
    if paged:
        before.update(pages=list(eng.pool._free_pages),
                      ref=list(eng.pool._page_ref),
                      slot_pages={s: list(p) for s, p in
                                  eng.pool._slot_pages.items()},
                      cow=eng.pool.cow_copies,
                      index=list(eng.prefix_index._map.items()),
                      counters=(eng.prefix_index.hits,
                                eng.prefix_index.misses))
    warm = eng.warmup()
    assert warm["decode_steps"] > 0 and warm["prefill_dispatches"] > 0
    for k, (ptr, val) in before_cache.items():
        assert eng.pool.cache[k].data_ptr() == ptr, k
        assert torch.equal(eng.pool.cache[k], val), k
    for k, ptr in stores.items():
        assert eng.pool.storage[k].data_ptr() == ptr, k
    assert dict(eng.stats) == before["stats"] and eng.clock == before["clock"]
    assert set(eng.pool._free) == before["free"]
    assert set(eng.pool._allocated) == before["alloc"]
    assert {r: v.tokens for r, v in eng.results.items()} == before["results"]
    if paged:
        assert list(eng.pool._free_pages) == before["pages"]
        assert list(eng.pool._page_ref) == before["ref"]
        assert {s: list(p) for s, p in eng.pool._slot_pages.items()} \
            == before["slot_pages"]
        assert eng.pool.cow_copies == before["cow"]
        assert list(eng.prefix_index._map.items()) == before["index"]
        assert (eng.prefix_index.hits, eng.prefix_index.misses) \
            == before["counters"]
        eng.check_invariants()
    res = eng.run([_req(Request, 2, 9, 4)])
    assert res[2].status == "ok" and len(res[2].tokens) == 4


# --------------------------------------------------------------- streaming

def test_stream_callbacks_match_jax_once_per_result(fp32):
    """``on_token`` streams JAX's (rid, tokens, tick) sequence and
    ``on_result`` fires exactly once a request for every terminal status:
    ok, expired (queued and in flight), cancelled (queued and in flight),
    quarantined; a preempted request streams each token once."""
    logs = []
    for e, cls in zip(_engines(fp32, page_size=8, num_slots=3),
                      (Request, JaxRequest)):
        toks, results = [], []
        e.set_stream_callbacks(
            on_token=lambda rid, t, tick, toks=toks: toks.append(
                (rid, [int(x) for x in t], tick)),
            on_result=lambda r, results=results: results.append(
                (r.rid, r.status)))
        for r in (_req(cls, 0, 8, 8), _req(cls, 1, 8, 8, deadline=6.0),
                  _req(cls, 2, 9, 6), _req(cls, 3, 8, 8),
                  _req(cls, 4, 8, 4, deadline=2.0), _req(cls, 5, 8, 4),
                  _req(cls, 6, 8, 5)):
            e.submit(r)
        e.cancel(5)
        e.inject_bad(3)
        e.step()
        e.step()
        e.cancel(2)
        e.step()
        e.preempt(0)
        e.run()
        logs.append((toks, results))
    assert logs[0] == logs[1]
    toks, results = logs[0]
    assert sorted(rid for rid, _ in results) == list(range(7))
    assert {s for _, s in results} == {"ok", "expired", "cancelled",
                                       "quarantined"}
    streamed = {}
    for rid, t, _ in toks:
        streamed.setdefault(rid, []).extend(t)
    assert len(streamed[0]) == 8


# ----------------------------------------------------------------- auditing

def test_pool_check_env_audits_every_step(fp32, monkeypatch):
    """``REPRO_POOL_CHECK=1`` audits the pool after every step: corruption
    planted between steps raises at the next one."""
    monkeypatch.setenv("REPRO_POOL_CHECK", "1")
    eng = _engines(fp32, page_size=8)[0]
    eng.submit(_req(Request, 0, 9, 6))
    eng.step()
    eng.pool._page_ref[eng.pool.slot_page(0, 0)] += 1
    with pytest.raises(AssertionError, match="refcount"):
        eng.step()


class _AlwaysSlow(StragglerMonitor):
    def observe(self, step, dt):
        return True


def test_straggler_monitor_counts_slow_steps(fp32):
    eng = _engines(fp32, straggler=_AlwaysSlow(threshold=3.0))[0]
    steps = []
    inner = eng._step
    eng._step = lambda: steps.append(1) or inner()
    eng.run([_req(Request, 0, 8, 4)])
    assert eng.stats["straggler_steps"] == len(steps) > 0
    assert eng.stats["straggler_threshold"] == 3.0


# ----------------------------------------------------------- the launcher

@pytest.mark.parametrize("kw", [
    dict(num_pages=4), dict(prefix_reuse=False), dict(deadline=0.0),
    dict(deadline=-2.0), dict(straggler_threshold=1.0),
    dict(page_size=8, num_pages=4, prefix_reuse=False, deadline=5.0,
         straggler_threshold=3.0),
    dict(page_size=8)])
def test_serve_config_fields_validate_as_jax(kw):
    """Each new field refuses what JAX's refuses, and takes what it takes."""
    jax_ok = port_ok = True
    try:
        JaxServeConfig(**kw).validate()
    except JaxServeConfigError:
        jax_ok = False
    try:
        ServeConfig(**kw).validate()
    except ServeConfigError:
        port_ok = False
    assert port_ok == jax_ok


def test_serve_parser_takes_the_jax_flags():
    argv = ["--page-size", "8", "--num-pages", "12", "--no-prefix-reuse",
            "--deadline", "30", "--straggler-threshold", "2.5"]
    ns, jns = build_parser().parse_args(argv), jax_build_parser().parse_args(argv)
    for name in ("page_size", "num_pages", "prefix_reuse", "deadline",
                 "straggler_threshold"):
        assert getattr(ns, name) == getattr(jns, name), name
    assert ServeConfig.from_args(build_parser().parse_args([])).prefix_reuse


def test_serve_cli_paged_smoke(capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu --page-size
    8 --trace 6`` serves every request, with the tokens of the contiguous
    run; ``--deadline`` prints the fault and status lines."""
    run = serve.main(["--smoke", "--device", "cpu", "--page-size", "8",
                      "--trace", "6"])
    out = capsys.readouterr().out
    assert "paged (" in out and "prefix reuse on" in out
    assert len(run.results) == 6
    assert all(r.status == "ok" for r in run.results.values())
    flat = serve.main(["--smoke", "--device", "cpu", "--trace", "6"])
    for rid, r in flat.results.items():
        assert run.results[rid].tokens == r.tokens, rid
    capsys.readouterr()
    tight = serve.main(["--smoke", "--device", "cpu", "--page-size", "8",
                        "--trace", "6", "--deadline", "6"])
    out = capsys.readouterr().out
    assert "results by status:" in out and "expired=" in out
    assert any(r.status == "expired" for r in tight.results.values())
