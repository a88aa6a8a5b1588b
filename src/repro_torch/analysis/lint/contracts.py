"""Per-recipe contract snapshots: the checked-in record of what each serve
path of the port is ALLOWED to look like (port of
``repro.analysis.lint.contracts``; the port's own files, under
``contracts/``, beside none of the reference's).

A contract (``contracts/<recipe>[.<DxM>][+paged].json``) pins only what
the port's own code decides:

  * the pool's leaves (dtype and shape, this rank's),
  * per path, the int8 → float convert ledger (count and bytes of the
    converts outside every kernel, and each one's shape and dtype),
  * per path, the logical collectives by kind (count and result bytes,
    from ``sharding.collectives``' events),
  * per path, the in-place audit (pool leaves kept, views written),

plus the engine fingerprint (arch + serving knobs — a contract applies to
the geometry it was generated under), the warmup shape set, and an
explicit ``known_debt`` list, each entry with a ``why``: the deliberate
violations the linter tolerates. Raw aten op counts are never pinned: they
move between torch releases while the port's code stands still.

``--update`` regenerates snapshots (deriving the debt list from the
current graph); ``--check`` diffs them and turns drift into failures. The
debt list is a ratchet: it may shrink or hold, never grow (``debt_growth``).
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .rules import (
    collective_table,
    convert_ledger,
    inplace_info,
    is_cache_dequant,
    pool_collective_hits,
)

CONTRACT_DIR = os.path.join(os.path.dirname(__file__), "contracts")

DEBT_WHY = {
    "dtype-ledger": (
        "the chunked prefill dequantizes the slot's int8 cache ring in eager "
        "torch and attends over the float copy (models/layers.py "
        "_cached_attention, as the reference's batched prefill attention); "
        "an int8 prefill attention kernel removes it (ROADMAP Parked 1)"
    ),
    "donation-audit": (
        "the paged pool gathers every slot's pages into a dense view that "
        "the dispatch runs on, then commits the written window back "
        "(serving/engine.py _paged_view / _paged_commit): a second copy of "
        "the KV payload; a decode attention that reads the page table "
        "removes it (ROADMAP Parked 8)"
    ),
    "collective-budget": (
        "a collective returns a whole pool leaf on a sharded path; keeping "
        "the pool shard-resident removes it"
    ),
}

#: the port's known debts at any geometry: what ``lint_engine`` tolerates
#: on an engine no contract pins (``"*"`` matches any path or shape) — the
#: chunked prefill's whole-ring dequant and the paged dense view
STRUCTURAL_DEBT = (
    [{"rule": "dtype-ledger", "jit": jit, "shape": "*",
      "why": DEBT_WHY["dtype-ledger"]} for jit in ("prefill", "prefill_multi")]
    + [{"rule": "donation-audit", "jit": "*", "where": "dense view",
        "why": DEBT_WHY["donation-audit"]}])


def contract_path(stem: str) -> str:
    return os.path.join(CONTRACT_DIR, f"{stem}.json")


def load_contract(stem: str) -> Optional[dict]:
    path = contract_path(stem)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_contract(stem: str, contract: dict) -> str:
    os.makedirs(CONTRACT_DIR, exist_ok=True)
    path = contract_path(stem)
    with open(path, "w") as f:
        json.dump(contract, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def structural_contract() -> dict:
    """The contract ``lint_engine`` applies where none pins the engine's
    geometry: no budgets, the structural debts alone."""
    return {"known_debt": [dict(d) for d in STRUCTURAL_DEBT]}


def _unique(entries: list) -> list:
    return [json.loads(e) for e in
            sorted({json.dumps(d, sort_keys=True) for d in entries})]


def snapshot(graph) -> dict:
    """Build a contract from a lint graph, deriving ``known_debt``: every
    prefill-path whole-ring dequant, pool-leaf collective and dense-view
    write in the CURRENT graph becomes an explicit debt entry (with a
    ``why``), so a fresh ``--update`` never blesses a decode-path dequant
    — that has no debt channel and stays an error."""
    debt: list = []
    jits: dict = {}
    for name, art in sorted(graph.jits.items()):
        entry: dict = {"kind": art.kind}
        if art.graph is None:
            jits[name] = entry
            continue
        entry["int8_converts"] = convert_ledger(art.graph)
        if art.kind != "decode":
            for r in art.graph.converts():
                if not r.in_kernel and is_cache_dequant(r, art):
                    debt.append({"rule": "dtype-ledger", "jit": name,
                                 "shape": list(r.shape), "dtype": r.dtype,
                                 "why": DEBT_WHY["dtype-ledger"]})
        if art.kind != "kernel":
            entry["collectives"] = {
                op: list(row)
                for op, row in sorted(collective_table(art.graph).items())}
            info = inplace_info(art.graph, art)
            entry["in_place"] = {k: info[k]
                                 for k in ("leaves", "ok", "views")}
            for hit in pool_collective_hits(art.graph, art):
                debt.append({"rule": "collective-budget", "jit": name,
                             "op": hit["op"], "type": hit["type"],
                             "bytes": hit["bytes"],
                             "why": DEBT_WHY["collective-budget"]})
            if info["views"]:
                debt.append({"rule": "donation-audit", "jit": name,
                             "where": "dense view", "views": info["views"],
                             "why": DEBT_WHY["donation-audit"]})
        jits[name] = entry
    return {
        "recipe": graph.recipe,
        "mesh": ("x".join(map(str, graph.mesh_shape))
                 if graph.mesh_shape else None),
        "engine": dict(graph.engine),
        "pool": dict(sorted(graph.pool_leaves.items())),
        "warmup_shapes": sorted([j, int(d)] for j, d in graph.warmup_shapes),
        "jits": jits,
        "known_debt": _unique(debt),
    }


def debt_growth(old: Optional[dict], new: dict) -> list[dict]:
    """``known_debt`` entries present in ``new`` but not in ``old`` — each
    a blocking error in ``--check`` (debt may shrink or hold, never grow
    silently). A missing ``old`` grows nothing here: that case is already
    the louder "no contract" error."""
    if old is None:
        return []
    o = {json.dumps(d, sort_keys=True) for d in old.get("known_debt", [])}
    return [json.loads(d)
            for d in sorted({json.dumps(d, sort_keys=True)
                             for d in new.get("known_debt", [])} - o)]


def diff_contracts(old: Optional[dict], new: dict) -> list[str]:
    """Human-readable drift lines between two contracts (for the --update
    output and the summary). Empty list = identical."""
    if old is None:
        return [f"new contract ({len(new.get('jits', {}))} jits, "
                f"{len(new.get('known_debt', []))} known_debt entries)"]
    lines: list[str] = []
    for key in ("recipe", "mesh", "engine"):
        if old.get(key) != new.get(key):
            lines.append(f"{key}: {old.get(key)} -> {new.get(key)}")
    op, np_ = old.get("pool") or {}, new.get("pool") or {}
    for leaf in sorted(set(op) | set(np_)):
        if op.get(leaf) != np_.get(leaf):
            lines.append(f"pool leaf {leaf}: {op.get(leaf)} -> "
                         f"{np_.get(leaf)}")
    if old.get("warmup_shapes") != new.get("warmup_shapes"):
        o = {tuple(s) for s in old.get("warmup_shapes", [])}
        n = {tuple(s) for s in new.get("warmup_shapes", [])}
        for s in sorted(n - o):
            lines.append(f"warmup shape added: {s}")
        for s in sorted(o - n):
            lines.append(f"warmup shape removed: {s}")
    o_jits, n_jits = old.get("jits", {}), new.get("jits", {})
    for name in sorted(set(o_jits) | set(n_jits)):
        if name not in o_jits:
            lines.append(f"{name}: new jit")
            continue
        if name not in n_jits:
            lines.append(f"{name}: jit removed")
            continue
        o, n = o_jits[name], n_jits[name]
        if o.get("int8_converts") != n.get("int8_converts"):
            ol, nl = o.get("int8_converts") or {}, n.get("int8_converts") or {}
            lines.append(
                f"{name}: int8-convert ledger {ol.get('count')} ops / "
                f"{ol.get('bytes')} B -> {nl.get('count')} ops / "
                f"{nl.get('bytes')} B")
        oc, nc = o.get("collectives") or {}, n.get("collectives") or {}
        for kind in sorted(set(oc) | set(nc)):
            if oc.get(kind) != nc.get(kind):
                lines.append(
                    f"{name}: {kind} {oc.get(kind, [0, 0])} -> "
                    f"{nc.get(kind, [0, 0])} [count, bytes]")
        oi, ni = o.get("in_place") or {}, n.get("in_place") or {}
        if oi != ni:
            lines.append(f"{name}: in-place audit {oi} -> {ni}")
    o_debt = {json.dumps(d, sort_keys=True)
              for d in old.get("known_debt", [])}
    n_debt = {json.dumps(d, sort_keys=True)
              for d in new.get("known_debt", [])}
    for d in sorted(n_debt - o_debt):
        e = json.loads(d)
        lines.append(f"known_debt added: {e.get('rule')} @ {e.get('jit')}")
    for d in sorted(o_debt - n_debt):
        e = json.loads(d)
        lines.append(f"known_debt REMOVED (a win): {e.get('rule')} @ "
                     f"{e.get('jit')}")
    return lines

