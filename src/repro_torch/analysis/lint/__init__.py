"""The graph linter: contracts over the port's recorded serve paths (port
of ``repro.analysis.lint``).

Parity tests pass even when a change makes the int8 path quietly worse: a
dequantize-multiply in eager torch, a copy of the pool, a graph captured
mid-traffic all stay bit-correct. This package checks those structural
facts directly:

  * ``graph_model`` — each serve path RECORDED as an op graph under a
    ``TorchDispatchMode`` (aten ops with dtypes, shapes, storages, the
    writes, the enclosing kernel; one node a kernel call; the logical
    collectives; the pool's storages around the call);
  * ``extract``    — records the engine's four paths (prefill, decode, the
    batched prefill, a decode horizon) and the standalone kernels for a
    recipe + mesh: static on ``meta`` copies, or live on an engine;
  * ``rules``      — the rule registry (``@register_rule``) with the five
    core rules: dtype-ledger, collective-budget, donation-audit (the
    in-place audit), recompilation-guard (the capture guard),
    scale-coupling;
  * ``contracts``  — per-recipe snapshots checked into
    ``contracts/<recipe>[.mesh][+paged].json``; ``--update`` regenerates
    them, ``--check`` diffs and fails on drift;
  * ``cli``        — ``python -m repro_torch.analysis.lint
    --check|--update|--list-rules`` and ``lint_engine``.

``graph_model`` and ``rules`` import torch alone; ``extract`` pulls in the
serving stack and is imported lazily.
"""
from __future__ import annotations

from .graph_model import (
    GraphRecorder,
    KernelNode,
    OpGraph,
    OpRecord,
    record_graph,
    type_bytes,
)
from .rules import Finding, list_rules, register_rule, run_rules

__all__ = [
    "GraphRecorder",
    "KernelNode",
    "OpGraph",
    "OpRecord",
    "record_graph",
    "type_bytes",
    "Finding",
    "register_rule",
    "run_rules",
    "list_rules",
    "build_graph",
    "graph_from_engine",
    "lint_engine",
]


def __getattr__(name):  # lazy: extract imports the serving stack
    if name in ("build_graph", "graph_from_engine", "LintGraph", "JitArtifact"):
        from . import extract

        return getattr(extract, name)
    if name == "lint_engine":
        from .cli import lint_engine

        return lint_engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
