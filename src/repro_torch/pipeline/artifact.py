"""QuantizedModel: the deployable output of the quantization pipeline (the
in-memory half of ``repro.pipeline.artifact``; save and load are a later
slice of the port).

Bundles the model, its (int8-packed) params, the recipe and the per-stage
report, and serves through the same prefill / decode path as fp params
(``QTensor`` dispatch in ``models.layers.linear``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..models.config import ModelConfig
from .recipes import Recipe


@dataclasses.dataclass
class QuantizedModel:
    """model + quantized params + recipe provenance + stage report."""

    model: Any
    cfg: ModelConfig
    params: Any
    recipe: Recipe
    report: list              # StageRecord.to_dict() per executed stage
    kv_bits: Optional[int] = None   # the kv_cache stage's record

    # ----------------------------------------------------------- inference
    def apply(self, tokens):
        return self.model.apply(self.params, tokens)

    def init_cache(self, batch: int, seq_len: int, **kwargs):
        if self.kv_bits is not None:
            kwargs.setdefault("kv_bits", self.kv_bits)
        return self.model.init_cache(batch, seq_len, **kwargs)

    def prefill(self, tokens, cache, **kwargs):
        return self.model.prefill(self.params, tokens, cache, **kwargs)

    def decode_step(self, token, cache):
        return self.model.decode_step(self.params, token, cache)

    # --------------------------------------------------------- diagnostics
    def serving_summary(self) -> dict:
        """Bytes accounting: fp vs int8 parameter payload."""
        from ..quantized.ptq import serving_summary

        return serving_summary(self.params)

    def stage_record(self, stage: str) -> Optional[dict]:
        """The last report record of ``stage`` (None if it did not run)."""
        for rec in reversed(self.report):
            if rec["stage"] == stage:
                return rec
        return None

    def site_sqnr_db(self) -> dict:
        """Per-site weight SQNR (dB) from the pack stage."""
        rec = self.stage_record("pack")
        if rec and "sqnr_db" in rec.get("metrics", {}):
            return dict(rec["metrics"]["sqnr_db"])
        return {}
