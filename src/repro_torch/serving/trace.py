"""Synthetic arrival schedules (port of ``repro.serving.trace``): log-uniform
prompt/gen lengths and exponential inter-arrival gaps from a numpy seed, so
the same seed gives the JAX package's requests exactly."""
from __future__ import annotations

import math

import numpy as np

from .scheduler import Request


def synthetic_trace(seed: int, n: int, *, vocab_size: int,
                    prompt_lens: tuple[int, int] = (4, 32),
                    gen_lens: tuple[int, int] = (4, 32),
                    mean_interarrival: float = 0.0,
                    deadline_slack: tuple[float, float] = (0.0, 0.0),
                    priority_levels: int = 1) -> list[Request]:
    """n requests with log-uniform lengths in the given inclusive ranges and
    Poisson arrivals on the engine-step clock."""
    rng = np.random.RandomState(seed)

    def log_uniform(lo: int, hi: int) -> int:
        u = rng.uniform(math.log(lo), math.log(hi + 1))
        return min(hi, max(lo, int(math.exp(u))))

    t = 0.0
    out = []
    for i in range(n):
        if mean_interarrival > 0:
            t += float(rng.exponential(mean_interarrival))
        P = log_uniform(*prompt_lens)
        G = log_uniform(*gen_lens)
        prompt = rng.randint(0, vocab_size, size=P).astype(np.int32)
        deadline = None
        if deadline_slack[1] > 0:
            deadline = t + float(rng.uniform(*deadline_slack))
        priority = (int(rng.randint(0, priority_levels))
                    if priority_levels > 1 else 0)
        out.append(Request(rid=i, prompt=prompt, max_new_tokens=G, arrival=t,
                           deadline=deadline, priority=priority))
    return out
