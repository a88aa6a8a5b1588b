"""Collective diagnostics over a recorded op graph — counterpart of the
reference's ``hlo_diag`` (which ranks the collectives of an optimized HLO
module): groups a path's logical collectives (``analysis.lint.graph_model
.OpGraph.collectives``, as ``sharding.collectives`` reports them) by kind
and result type and ranks them by bytes. The hypothesis generator for a
sharded path's traffic.
"""
from __future__ import annotations

from .lint.graph_model import type_str


def top_collectives(graph, k: int = 15):
    """Top-k collectives of an ``OpGraph`` by aggregate result bytes: rows
    of ``(bytes, count, kind, result type)``."""
    agg: dict = {}
    for kind, dtype, shape, nbytes in graph.collectives:
        key = (kind, type_str(dtype, shape))
        b, n = agg.get(key, (0, 0))
        agg[key] = (b + nbytes, n + 1)
    rows = [(b, n, kind, t) for (kind, t), (b, n) in agg.items()]
    rows.sort(reverse=True)
    return rows[:k]


def print_top(graph, k: int = 15):
    for b, n, kind, t in top_collectives(graph, k):
        print(f"{b/1e9:9.3f} GB  ×{n:<4d} {kind:18s} {t}")
