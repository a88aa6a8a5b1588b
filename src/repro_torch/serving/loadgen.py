"""Open-loop Poisson load generation and SLO accounting for the async server
(port of ``repro.serving.loadgen``, over the port's ``synthetic_trace``).

**Open loop** is the part that matters: arrival times come from the trace
alone (Poisson, rate ``qps`` in requests per engine tick) and NEVER wait on
completions. A closed-loop driver (submit, wait, submit) self-throttles
under overload and hides the latency cliff; an open-loop one keeps offering
load the way a fleet of independent users does, which is what exposes the
knee in the goodput curve and drives the shedding/breaker machinery the
server exists for.

``summarize`` turns the client outcomes into the SLO view: TTFT and
per-token latency percentiles over ok requests, plus **goodput** — the rate
of requests that both finished ok AND met the SLO (TTFT and per-token
bounds). Goodput vs offered QPS is the fleet metric: throughput keeps
rising past saturation while goodput flattens and then falls.

All times are engine ticks (one decode step == one tick).
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .client import AsyncClient, ClientOutcome
from .scheduler import Request
from .server import AsyncServer
from .trace import synthetic_trace


def open_loop_trace(seed: int, n: int, qps: float, *, vocab_size: int,
                    prompt_lens: tuple = (4, 32), gen_lens: tuple = (4, 32),
                    deadline_slack: tuple = (0.0, 0.0),
                    priority_levels: int = 1) -> List[Request]:
    """A Poisson arrival trace offered at ``qps`` requests per engine tick
    (``mean_interarrival = 1/qps``). Thin wrapper over ``synthetic_trace``
    so benches sweep a rate, not an inter-arrival gap."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    return synthetic_trace(
        seed, n, vocab_size=vocab_size, prompt_lens=prompt_lens,
        gen_lens=gen_lens, mean_interarrival=1.0 / qps,
        deadline_slack=deadline_slack, priority_levels=priority_levels)


async def run_open_loop(server: AsyncServer, client: AsyncClient,
                        trace: Sequence[Request], *,
                        timeout: Optional[float] = None,
                        close: bool = True) -> List[ClientOutcome]:
    """Drive the trace through the server open-loop: one client coroutine
    per request, each sleeping until its own arrival tick regardless of how
    the others fare. Returns outcomes in rid order. ``close=False`` leaves
    the server running (caller composes more load afterwards)."""
    if server._task is None:
        server.start()
    tasks = [asyncio.ensure_future(client.run(req, timeout=timeout))
             for req in sorted(trace, key=lambda r: (r.arrival, r.rid))]
    outcomes = list(await asyncio.gather(*tasks))
    if close:
        await server.aclose()
    return sorted(outcomes, key=lambda o: o.rid)


@dataclasses.dataclass
class SLO:
    """A request meets the SLO iff it finished ok, its TTFT is within
    ``ttft`` ticks of arrival, and its mean per-token gap is at most
    ``per_token`` ticks."""

    ttft: float = 32.0
    per_token: float = 4.0

    def met(self, o: ClientOutcome) -> bool:
        if not o.ok or o.ttft is None:
            return False
        if o.ttft > self.ttft:
            return False
        if len(o.token_ticks) > 1:
            gaps = np.diff(o.token_ticks)
            if float(np.mean(gaps)) > self.per_token:
                return False
        return True


def _pct(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else float("nan")


def summarize(outcomes: Sequence[ClientOutcome], *, slo: SLO,
              span_ticks: Optional[float] = None) -> dict:
    """SLO roll-up of one open-loop run.

    ``span_ticks`` (default: last arrival − first arrival, min 1) is the
    offered-load window, so ``offered_qps`` reflects the trace's actual
    realized rate rather than the nominal one. Completion rates
    (``completed_qps`` / ``goodput_qps``) divide by the SERVE span (first
    arrival → last completion) instead: past saturation a burst of arrivals
    is served over a much longer window than it was offered in, and that
    stretch is exactly the degradation the knee plot must show.
    """
    n = len(outcomes)
    ok = [o for o in outcomes if o.ok]
    met = [o for o in ok if slo.met(o)]
    arrivals = [o.arrival for o in outcomes]
    if span_ticks is None:
        span_ticks = max(1.0, max(arrivals) - min(arrivals)) if arrivals else 1.0
    finishes = [o.finished_tick for o in outcomes
                if o.finished_tick is not None]
    serve_span = max(1.0, span_ticks)
    if arrivals and finishes:
        serve_span = max(serve_span, max(finishes) - min(arrivals))
    ttfts = [o.ttft for o in ok if o.ttft is not None]
    gaps: List[float] = []
    for o in ok:
        if len(o.token_ticks) > 1:
            gaps.extend(float(g) for g in np.diff(o.token_ticks))
    statuses: dict = {}
    for o in outcomes:
        statuses[o.status] = statuses.get(o.status, 0) + 1
    return {
        "n_requests": n,
        "n_ok": len(ok),
        "n_slo_met": len(met),
        "statuses": statuses,
        "offered_span_ticks": span_ticks,
        "serve_span_ticks": serve_span,
        "offered_qps": n / span_ticks,
        "completed_qps": len(ok) / serve_span,
        "goodput_qps": len(met) / serve_span,
        "goodput_fraction": (len(met) / n) if n else 0.0,
        "ttft_p50": _pct(ttfts, 50),
        "ttft_p99": _pct(ttfts, 99),
        "per_token_p50": _pct(gaps, 50),
        "per_token_p99": _pct(gaps, 99),
        "mean_attempts": float(np.mean([o.attempts for o in outcomes]))
        if outcomes else 0.0,
    }
