"""Straggler detection (the ``StragglerMonitor`` of
``repro.runtime.fault_tolerance``; its retry-with-restore loop and
preemption hook are later slices of the port).

The monitor keeps an EMA of per-step wall time; a step slower than
``threshold ×`` the EMA is counted as a straggler (and handed to
``on_straggler``). The first ``warmup_steps`` steps are not judged, and a
slow step moves the EMA by at most ``threshold ×`` it.
"""
from __future__ import annotations

from typing import Callable, Optional


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ema_decay: float = 0.9,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.ema_decay = ema_decay
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.events: list[tuple[int, float, float]] = []
        self._seen = 0
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        """Record one step of ``dt`` seconds; True if it straggled."""
        self._seen += 1
        if self._seen <= self.warmup:
            return False
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.threshold * self.ema
        if is_straggler:
            self.events.append((step, dt, self.ema))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
        # slow steps don't poison the EMA
        self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * min(
            dt, self.threshold * self.ema)
        return is_straggler
