"""The async front-end over a mesh (``repro_torch.serving.mesh_control``):
rank 0 runs ``AsyncServer`` / ``AsyncClient`` / ``run_open_loop`` as on one
device and leads; every other rank replays rank 0's accepted engine calls
and steps over a gloo group of their own. On the CPU over gloo, at 1x2 and
2x1, fp32 and ``serve-w8a8-kv8-tp``: under underload, overload (queue
retries, priority shedding, the breaker opening) and a drain, every
request's outcome — status, attempts, tokens, token ticks, first-token and
finish ticks — the admission counters, the breaker's opens and the
terminal statuses equal the port's one-device run and the JAX front-end's
over the JAX engine. A follower that fails ends every rank, well inside
the control group's timeout. ``ServeConfig(mesh=..., serve_async=True)``
validates, and the launcher serves it; a SIGTERM to the launcher drains the
mesh as the one device drains at the same tick.

Each group of ranks is spawned once a module (``_torch_sharded.run_ranks``),
every scenario in that one spawn; the failing follower gets a spawn of its
own.
"""
import math
import os
import signal
import threading
import time

import pytest

import repro
import repro.serving as jserving

import repro_torch
import repro_torch.serving as tserving
from repro_torch.serving import ServingEngine

from _torch_port import jax_to_numpy
from _torch_sharded import _model, async_run, run_ranks

ARCH = "qwen2-0.5b-smoke"
VARIANTS = ["fp32", "serve-w8a8-kv8-tp"]
SCENARIOS = ["underload", "overload", "drain"]
MESHES = [(1, 2), (2, 1)]
#: the async tests' engine (test_torch_serving_async.py's), queue of 4
ENGINE = dict(num_slots=2, max_len=32, prefill_chunk=8, decode_horizon=4,
              max_queue=4)
#: the failing follower's control timeout (seconds)
FAIL_TIMEOUT = 60.0


def _engine_kw(scenario):
    """The overload run's queue is bounded, the others' not."""
    return {k: v for k, v in ENGINE.items()
            if scenario == "overload" or k != "max_queue"}


@pytest.fixture(scope="module")
def sides():
    """{variant: (JAX model, params, cfg, numpy params, kv_bits)}."""
    import jax
    from repro.configs import get_config
    from repro.models import build_model

    jm = build_model(get_config("qwen2-0.5b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    out = {}
    for variant in VARIANTS:
        m, p, c = jm, jp, jm.cfg
        if variant != "fp32":
            qm = repro.quantize(jm, params=jp, recipe=variant)
            m, p, c = qm.model, qm.params, qm.cfg
        out[variant] = (m, p, c, jax_to_numpy(p), 8 if "kv8" in variant
                        else 16)
    return out


def _task(sides, shape, variant, scenario, **kw):
    _, _, _, params_np, kv_bits = sides[variant]
    return (("async", shape, variant, scenario), "async", shape,
            dict(arch=ARCH, params=params_np, kv_bits=kv_bits,
                 scenario=scenario, engine=_engine_kw(scenario), **kw))


CASES = [(s, v, sc) for s in MESHES for v in VARIANTS for sc in SCENARIOS]


@pytest.fixture(scope="module")
def world2(sides, tmp_path_factory):
    return run_ranks(2, [_task(sides, *c) for c in CASES],
                     tmp_path_factory.mktemp("async2"))


_SINGLE: dict = {}


def _single(sides, variant, scenario):
    """The port's one-device run of a scenario."""
    key = (variant, scenario)
    if key not in _SINGLE:
        _, _, _, params_np, kv_bits = sides[variant]
        model, p, cfg = _model(ARCH, None, params_np)
        eng = ServingEngine(model, p, cfg, device="cpu", kv_bits=kv_bits,
                            **_engine_kw(scenario))
        _SINGLE[key] = async_run(tserving, eng, scenario, cfg.vocab_size)
    return _SINGLE[key]


_JAX: dict = {}


def _jax(sides, variant, scenario):
    """The JAX front-end over the JAX engine on the same weights."""
    key = (variant, scenario)
    if key not in _JAX:
        jm, jp, jcfg, _, kv_bits = sides[variant]
        eng = jserving.ServingEngine(jm, jp, jcfg, kv_bits=kv_bits,
                                     **_engine_kw(scenario))
        _JAX[key] = async_run(jserving, eng, scenario, jcfg.vocab_size)
    return _JAX[key]


def _case_id(c):
    shape, variant, scenario = c
    return f"{'x'.join(map(str, shape))}-{variant}-{scenario}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_async_over_a_mesh_matches_one_device_and_jax(case, sides, world2):
    """Every outcome, the admission counters, the breaker's opens and the
    terminal statuses equal the port's one-device run and JAX's front-end;
    the control stream went over its own gloo group, one batch a step and
    the stop."""
    shape, variant, scenario = case
    got = world2[("async",) + case]
    one = _single(sides, variant, scenario)
    assert got["run"] == one
    assert got["run"] == _jax(sides, variant, scenario)
    assert got["batches"] > 1


def test_scenarios_exercise_what_they_claim(sides):
    """Underload: every request ok at its first attempt. Overload: sheds,
    retries and a breaker opening. Drain: the requests admitted before it
    finish ok, the later ones are refused (``QueueFull``) until their
    retries run out."""
    outcomes, stats, opens, results = _single(sides, "fp32", "underload")
    assert all(o[1] == "ok" and o[2] == 1 for o in outcomes)
    outcomes, stats, opens, results = _single(sides, "fp32", "overload")
    assert stats["shed_priority"] + stats["shed_queue"] > 0 and opens >= 1
    assert max(o[2] for o in outcomes) > 1
    outcomes, stats, opens, results = _single(sides, "fp32", "drain")
    assert {o[1] for o in outcomes} == {"ok", "shed"}
    assert all(o[2] == 3 for o in outcomes if o[1] == "shed")
    assert stats["shed_queue"] > 0


def test_a_failing_follower_ends_every_rank(sides, tmp_path):
    """A follower that raises at its third replayed step exits non-zero
    with its error, and rank 0 — waiting for it in a collective of its
    step — is stopped at once, as the launcher stops it: the group ends
    well inside the control timeout, rank 0 with no result."""
    t0 = time.monotonic()
    res = run_ranks(2, [_task(sides, (1, 2), "fp32", "overload", fail_at=3,
                              timeout=FAIL_TIMEOUT)],
                    tmp_path, timeout=2 * FAIL_TIMEOUT, collect=True)
    took = time.monotonic() - t0
    assert isinstance(res[1], str) and "follower failed at step 3" in res[1]
    assert not isinstance(res.get(0), dict)
    assert took < FAIL_TIMEOUT, took


def test_a_leader_failure_aborts_the_followers(sides, tmp_path):
    """Rank 0 failing sends the abort: the follower raises naming rank 0's
    error, before any timeout."""
    t0 = time.monotonic()
    res = run_ranks(2, [_task(sides, (1, 2), "fp32", "underload",
                              fail_leader=True, timeout=FAIL_TIMEOUT)],
                    tmp_path, timeout=2 * FAIL_TIMEOUT, collect=True,
                    stop_on_failure=False)
    assert time.monotonic() - t0 < FAIL_TIMEOUT
    assert "leader failed" in res[0]
    assert "mesh rank 0 failed: RuntimeError: leader failed" in res[1]


def test_serve_async_with_a_mesh_validates_and_serves():
    """``ServeConfig(mesh=(1, 2), serve_async=True)`` validates, and the
    launcher serves the trace over the mesh: rank 0's report, the
    one-device run's outcomes and counters."""
    kw = dict(smoke=True, device="cpu", serve_async=True, trace=10, qps=1.0,
              timeout=48.0, max_queue=4)
    repro_torch.ServeConfig(mesh=(1, 2), **kw).validate()
    sharded = repro_torch.serve(repro_torch.ServeConfig(mesh=(1, 2), **kw))
    single = repro_torch.serve(repro_torch.ServeConfig(**kw))
    assert sharded.mesh == (1, 2) and len(sharded.rank_launches) == 2
    assert sharded.outcomes == single.outcomes
    assert sharded.server_stats == single.server_stats
    assert sharded.async_summary == single.async_summary


def _no_nan(summary):
    return {k: None if isinstance(v, float) and math.isnan(v) else v
            for k, v in summary.items()}


def test_sigterm_to_the_launcher_drains_the_mesh_as_one_device(monkeypatch):
    """A SIGTERM to the launcher's process under ``--serve-async --mesh
    1x2``: the launcher writes the drain file (its ranks ignore SIGTERM),
    rank 0 reads it at a step boundary and closes admission, and the
    follower replays the drain with that step. The run reports the drain,
    and every outcome, the server's counters and the SLO summary equal the
    one device's run drained at the same tick."""
    from repro_torch.serving import ServingEngine

    kw = dict(smoke=True, device="cpu", serve_async=True, trace=10, qps=1.0,
              timeout=48.0, max_queue=4)
    late: list = []
    before = signal.signal(signal.SIGTERM, lambda *_: late.append(1))
    ours = signal.getsignal(signal.SIGTERM)

    done = threading.Event()

    def send():
        # once the launcher holds SIGTERM (its ranks started), signal it;
        # a signal that comes too late lands in ``late``
        while signal.getsignal(signal.SIGTERM) is ours and not done.is_set():
            time.sleep(0.01)
        if not done.is_set():
            os.kill(os.getpid(), signal.SIGTERM)

    sender = threading.Thread(target=send, daemon=True)
    try:
        sender.start()
        sharded = repro_torch.serve(repro_torch.ServeConfig(mesh=(1, 2),
                                                            **kw))
        assert signal.getsignal(signal.SIGTERM) is ours
    finally:
        done.set()
        sender.join(10)
        signal.signal(signal.SIGTERM, before)
    assert not late, "the signal reached the test, not the launcher"
    assert sharded.mesh == (1, 2) and sharded.drained
    assert sharded.drained_at is not None

    step, sent = ServingEngine.step, []

    def step_then_signal(self):
        if not sent and self.clock >= sharded.drained_at:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self)

    monkeypatch.setattr(ServingEngine, "step", step_then_signal)
    single = repro_torch.serve(repro_torch.ServeConfig(**kw))
    assert single.drained and single.drained_at == sharded.drained_at
    assert sharded.outcomes == single.outcomes
    assert sharded.server_stats == single.server_stats
    # a summary with nothing served holds NaN percentiles
    assert _no_nan(sharded.async_summary) == _no_nan(single.async_summary)
    assert {r: list(v.tokens) for r, v in sharded.results.items()} == \
        {r: list(v.tokens) for r, v in single.results.items()}
