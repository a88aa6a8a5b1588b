"""Pipeline state: the value threaded through every stage (port of
``repro.pipeline.state``).

A stage is a function ``(state, ctx, **options) -> state`` over a
``PipelineState`` carrying the params tree, the architecture's ``DFQPlan``,
the active ``DFQConfig`` and the per-stage diagnostics. The
``PipelineContext`` carries what stages may read but not change: the model,
its config, and the calibration hook supplying E[x] per stat key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

from ..core.dfq import DFQConfig
from ..core.graph import DFQPlan


class PipelineError(Exception):
    """A pipeline misuse with an actionable message."""


class RecipeError(PipelineError):
    """Recipe validation failure: unknown stage, bad option, malformed spec."""


@dataclasses.dataclass
class StageRecord:
    """Diagnostics for one executed stage (what ``QuantizedModel.report``
    holds)."""

    stage: str
    options: dict
    seconds: float
    metrics: dict

    def to_dict(self) -> dict:
        return {"stage": self.stage, "options": dict(self.options),
                "seconds": float(self.seconds), "metrics": self.metrics}


@dataclasses.dataclass
class PipelineContext:
    """Read-only context handed to every stage."""

    model: Any = None
    cfg: Any = None
    # calibrate(params) -> {stat_key: E[x]} — the model-side hook (synthetic
    # tokens keep the flow data-free); None when no calibration is available
    calibrate: Optional[Callable[[Mapping], Mapping]] = None


@dataclasses.dataclass
class PipelineState:
    params: Any
    plan: DFQPlan
    config: DFQConfig = dataclasses.field(default_factory=DFQConfig)
    fp_params: Any = None          # pre-quantization snapshot (SQNR reference)
    input_means: Optional[Mapping] = None
    act_qparams: dict = dataclasses.field(default_factory=dict)
    packed: bool = False
    pack_mode: Optional[str] = None
    kv_bits: Optional[int] = None  # set by the kv_cache stage (8 → int8 KV)
    shard_mode: Optional[str] = None  # set by the shard stage ("tp")
    records: list = dataclasses.field(default_factory=list)
    _pending_metrics: dict = dataclasses.field(default_factory=dict)

    def note(self, **metrics) -> None:
        """Attach metrics to the currently-running stage's record."""
        self._pending_metrics.update(metrics)

    def pop_metrics(self) -> dict:
        m, self._pending_metrics = self._pending_metrics, {}
        return m

    @property
    def report(self) -> list:
        return [r.to_dict() for r in self.records]
