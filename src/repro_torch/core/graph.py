"""Equalization-graph descriptors (port of ``repro.core.graph``): a
declarative, model-agnostic encoding of where DFQ's rewrites apply inside a
parameter tree.

A model emits a ``DFQPlan`` from its config (``LMModel.dfq_plan``);
``core.dfq`` executes its ops functionally over the params. Paths address
layer-stacked ``[L, ...]`` weights — the core transforms broadcast over the
leading dims, so one op equalizes every layer of a kind at once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .tree import Path


@dataclasses.dataclass(frozen=True)
class NormFoldOp:
    """Fold norm scale (and LayerNorm shift) into consuming linears."""

    norm_w: Path
    consumers: Sequence[Path]            # weight paths, [..., d_in, out]
    norm_b: Optional[Path] = None
    consumer_biases: Optional[Sequence[Optional[Path]]] = None


@dataclasses.dataclass(frozen=True)
class DensePairOp:
    """CLE over a ReLU / gated-MLP pair (exact). w1 [..., d, n], w2 [..., n, d]."""

    w1: Path
    w2: Path
    b1: Optional[Path] = None
    exact: bool = True                   # False → approximate (plain GELU MLP)


@dataclasses.dataclass(frozen=True)
class VOPairOp:
    """CLE value-proj ↔ output-proj through attention (exact, GQA-aware)."""

    wv: Path
    wo: Path
    bv: Optional[Path] = None
    n_q: int = 1
    n_kv: int = 1
    head_dim: int = 1


@dataclasses.dataclass(frozen=True)
class QKPairOp:
    """CLE query ↔ key (exact; RoPE rotation-pair and GQA-group constrained)."""

    wq: Path
    wk: Path
    bq: Optional[Path] = None
    bk: Optional[Path] = None
    n_q: int = 1
    n_kv: int = 1
    head_dim: int = 1
    rope: bool = True


@dataclasses.dataclass(frozen=True)
class VBiasAbsorbOp:
    """Absorb the value bias fully into the output-projection bias (exact)."""

    bv: Path
    wo: Path
    bo: Path
    n_q: int = 1
    n_kv: int = 1
    head_dim: int = 1


@dataclasses.dataclass(frozen=True)
class HighBiasAbsorbOp:
    """Paper §4.1.3: absorb c = max(0, β − 3γ) from b1 into (w2, b2).

    beta/gamma paths point at stored pre-activation statistics; dense layout.
    """

    b1: Path
    w2: Path
    b2: Path
    beta: Path
    gamma: Path


@dataclasses.dataclass(frozen=True)
class WeightSite:
    """One quantizable linear: the pack stage's unit (and, in a later slice,
    bias correction's: ``stat_key`` names the activation statistic whose
    mean is E[input] for this site)."""

    name: str
    w: Path
    b: Optional[Path] = None
    kind: str = "dense"                  # dense | conv | depthwise
    stat_key: Optional[str] = None


PlanOp = (
    NormFoldOp
    | DensePairOp
    | VOPairOp
    | QKPairOp
    | VBiasAbsorbOp
    | HighBiasAbsorbOp
)


@dataclasses.dataclass(frozen=True)
class DFQPlan:
    """Everything DFQ needs to know about one architecture."""

    ops: Sequence[PlanOp]
    sites: Sequence[WeightSite]
    name: str = ""
