"""The port's end-to-end pin of the ``serving.errors`` retryable contract
(``tests/test_serving_errors_contract.py`` restated on
``repro_torch.serving``): the taxonomy's retryable bit for every class,
every retryable class round-tripping through the client's retry path,
every non-retryable class failing fast, exhausted retries surfacing as
``shed`` — and the backoff schedule drawn bit for bit as the JAX
``RetryPolicy`` draws it. A scripted in-memory server stands in for the
engine so each error class can be injected at the admission surface."""
import asyncio
import dataclasses

import numpy as np
import pytest

import repro.serving as jax_serving

from repro_torch.serving import (
    AsyncClient,
    CircuitOpen,
    DeadlineExceeded,
    PoolExhausted,
    QueueFull,
    Request,
    RequestCancelled,
    RequestStream,
    RequestTooLarge,
    RetryPolicy,
    ServerOverloaded,
    ServingError,
    taxonomy,
)

EXPECTED_TAXONOMY = {
    "ServingError": False,
    "RequestTooLarge": False,
    "QueueFull": True,
    "PoolExhausted": True,
    "RequestCancelled": False,
    "DeadlineExceeded": False,
    "CircuitOpen": True,
    "ServerOverloaded": True,
}

BY_NAME = {
    "ServingError": ServingError,
    "RequestTooLarge": RequestTooLarge,
    "QueueFull": QueueFull,
    "PoolExhausted": PoolExhausted,
    "RequestCancelled": RequestCancelled,
    "DeadlineExceeded": DeadlineExceeded,
    "CircuitOpen": CircuitOpen,
    "ServerOverloaded": ServerOverloaded,
}


def test_taxonomy_pinned_exactly():
    assert taxonomy() == EXPECTED_TAXONOMY == jax_serving.taxonomy()


def test_legacy_isa_compat():
    assert issubclass(RequestTooLarge, ValueError)
    assert issubclass(QueueFull, RuntimeError)
    assert issubclass(PoolExhausted, RuntimeError)
    assert issubclass(CircuitOpen, RuntimeError)
    assert issubclass(ServerOverloaded, RuntimeError)
    for cls in BY_NAME.values():
        assert issubclass(cls, ServingError)


@dataclasses.dataclass
class _Result:
    rid: int
    status: str
    tokens: list
    finished_at: float


class _ScriptedServer:
    """Admission surface double: raises a scripted error sequence, then
    serves a one-token stream (clock moves only through the wait_* calls
    the client makes)."""

    def __init__(self, errors):
        self.errors = list(errors)
        self.clock = 0.0
        self.submits = 0

    def submit(self, request, *, timeout=None):
        self.submits += 1
        if self.errors:
            raise self.errors.pop(0)
        stream = RequestStream(request.rid)
        stream._push(self.clock, 7)
        stream._finish(_Result(rid=request.rid, status="ok", tokens=[7],
                               finished_at=self.clock))
        return stream

    async def wait_until(self, tick):
        self.clock = max(self.clock, tick)

    async def wait_ticks(self, n):
        assert n >= 0
        self.clock += n


def _req(rid=0):
    return Request(rid=rid, prompt=np.arange(4, dtype=np.int32),
                   max_new_tokens=1)


@pytest.mark.parametrize("name", sorted(k for k, v in EXPECTED_TAXONOMY.items()
                                        if v))
def test_every_retryable_error_round_trips(name):
    server = _ScriptedServer([BY_NAME[name](f"scripted {name}")])
    client = AsyncClient(server, RetryPolicy(max_attempts=3), seed=0)
    out = asyncio.run(client.run(_req()))
    assert out.ok and out.tokens == [7]
    assert out.attempts == 2 and server.submits == 2
    assert server.clock > 0.0


@pytest.mark.parametrize("name", sorted(k for k, v in EXPECTED_TAXONOMY.items()
                                        if not v))
def test_every_nonretryable_error_fails_fast(name):
    server = _ScriptedServer([BY_NAME[name](f"scripted {name}")])
    client = AsyncClient(server, RetryPolicy(max_attempts=3), seed=0)
    out = asyncio.run(client.run(_req()))
    assert not out.ok
    assert out.status == "rejected" and out.error == name
    assert out.attempts == 1 and server.submits == 1
    assert server.clock == 0.0


def test_retries_exhausted_is_shed():
    server = _ScriptedServer([QueueFull("full")] * 10)
    client = AsyncClient(server, RetryPolicy(max_attempts=4), seed=0)
    out = asyncio.run(client.run(_req()))
    assert out.status == "shed" and out.error == "QueueFull"
    assert out.attempts == 4 and server.submits == 4


def test_backoff_is_seeded_and_capped():
    policy = RetryPolicy(max_attempts=8, base_backoff=4.0, multiplier=2.0,
                         max_backoff=16.0)
    a = AsyncClient(_ScriptedServer([]), policy, seed=3)
    b = AsyncClient(_ScriptedServer([]), policy, seed=3)
    sched_a = [policy.backoff(k, a._rng(5)) for k in range(6)]
    sched_b = [policy.backoff(k, b._rng(5)) for k in range(6)]
    assert sched_a == sched_b
    assert sched_a != [policy.backoff(k, a._rng(6)) for k in range(6)]
    for k, delay in enumerate(sched_a):
        assert 0.0 <= delay <= min(4.0 * 2.0 ** k, 16.0)


@pytest.mark.parametrize("seed,rid", [(0, 0), (3, 5), (7, 123456)])
def test_backoff_draws_equal_the_jax_policy(seed, rid):
    """Both packages seed ``np.random.RandomState`` per (seed, rid): the
    whole jittered schedule is bit-equal to the JAX ``RetryPolicy``'s, and
    so is a full scripted retry run's clock."""
    kw = dict(max_attempts=8, base_backoff=3.0, multiplier=1.7,
              max_backoff=40.0)
    port, ref = RetryPolicy(**kw), jax_serving.RetryPolicy(**kw)
    pc = AsyncClient(_ScriptedServer([]), port, seed=seed)
    jc = jax_serving.AsyncClient(_ScriptedServer([]), ref, seed=seed)
    rp, rj = pc._rng(rid), jc._rng(rid)
    assert [port.backoff(k, rp) for k in range(7)] == [
        ref.backoff(k, rj) for k in range(7)]
    ps = _ScriptedServer([QueueFull("full")] * 5)
    js = _ScriptedServer([jax_serving.QueueFull("full")] * 5)
    po = asyncio.run(AsyncClient(ps, port, seed=seed).run(_req(rid)))
    jo = asyncio.run(jax_serving.AsyncClient(js, ref, seed=seed).run(
        jax_serving.Request(rid=rid, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=1)))
    assert ps.clock == js.clock and po.attempts == jo.attempts == 6
    assert po.token_ticks == jo.token_ticks
