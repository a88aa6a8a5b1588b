"""The lint rule registry and the five core serving-graph rules (port of
``repro.analysis.lint.rules``).

A rule is a function ``fn(graph, contract) -> list[Finding]`` registered
under a name — external code can add project-specific rules without
touching the runner:

    @register_rule("my-rule")
    def my_rule(graph, contract):
        return [Finding("my-rule", "error", jit="decode", where="...",
                        message="...")]

``graph`` is an ``extract.LintGraph`` (duck-typed — the tests drive rules
with hand-built miniatures); ``contract`` is the parsed contract JSON for
the recipe, or ``None`` when none applies (structural checks still run;
contract-relative budgets are skipped). A debt entry whose keyed value is
``"*"`` (``contracts.STRUCTURAL_DEBT``) covers any value: the port's known
debts at a geometry no contract pins.

Each path is an ``OpGraph`` recorded from eager PyTorch
(``graph_model``), not an XLA module, and two facts change what the
reference's rules mean here:

  * **Nothing fuses.** XLA folds an int8 → float convert into the dot that
    reads it; eager torch does not. A convert outside a kernel therefore
    ALWAYS writes its float tensor to memory. The one exemption is a
    convert inside a kernel's scope (the registry's ``resolve``): the
    reference's ``in_pallas`` case, which on the card is the kernel's
    registers (the plain tier's ops stand in for them on the CPU).
  * **A convert is any op with an int8 input and a floating output** — an
    int8 tensor times a float scale is one ``aten.mul.Tensor``.

The five rules, under the reference's names:

  * **dtype-ledger** — a whole-ring dequant (a convert outside every
    kernel whose trailing dims are a cache ring's ``[S, Hkv, hd]``; a paged
    pool's dense view's) is an error on a decode path and must be pinned
    as contract ``known_debt`` on a prefill path (the chunked prefill's
    eager attention, ROADMAP Parked 1). Weight-shaped converts are counted
    in the ledger alone. The ledger — count and bytes of the converts
    outside kernels — is pinned per path.
  * **collective-budget** — each path's (count, bytes) per kind of the
    logical collectives it reports (``sharding.collectives``) must match
    the contract; under TP a collective whose result is a whole pool leaf
    (global or per-rank shape; the page table excluded) is an error unless
    pinned as debt.
  * **donation-audit** — the port's in-place audit (the pool is written in
    place, never donated): every pool leaf keeps its storage and address
    across a call (a captured CUDA graph holds them); no op outside a
    kernel allocates a tensor of a pool payload leaf's dtype and shape or
    writes the paged engine's dense view (a second copy of the payload,
    pinned as debt: ROADMAP Parked 8); on a warmed card engine every
    captured graph's pool addresses are the live pool's.
  * **recompilation-guard** — the port's capture guard: the dispatchable
    shapes are closed under the warmup set, and both equal the contract's;
    a live engine's captured graphs are warmup shapes, and after
    ``warmup()`` exactly them.
  * **scale-coupling** — every int8 payload leaf's scale shares its
    out-feature sharding axis (params) / its slot+head axes (KV cache), so
    a TP shard dequantizes locally without gathering foreign scales.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .graph_model import type_str

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str          # "error" | "warn" | "info"
    jit: str               # path / kernel name ("" = recipe-level)
    where: str             # op, leaf, shape signature
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def format(self) -> str:
        loc = f"{self.jit}:{self.where}" if self.where else self.jit
        return f"[{self.severity}] {self.rule} @ {loc}: {self.message}"


_RULES: dict[str, Callable] = {}


def register_rule(name: str):
    """Decorator: register ``fn(graph, contract) -> list[Finding]``."""

    def deco(fn):
        if name in _RULES:
            raise ValueError(f"lint rule {name!r} is already registered "
                             f"(by {_RULES[name].__module__})")
        _RULES[name] = fn
        return fn

    return deco


def list_rules() -> list[str]:
    return sorted(_RULES)


def run_rules(graph, contract: Optional[dict] = None,
              rules: Optional[list[str]] = None) -> list[Finding]:
    """Run ``rules`` (default: all registered) over one lint graph."""
    out: list[Finding] = []
    for name in rules or list_rules():
        try:
            fn = _RULES[name]
        except KeyError:
            raise ValueError(
                f"unknown lint rule {name!r}; registered: {list_rules()}"
            ) from None
        out.extend(fn(graph, contract))
    return out


# ============================================================ the ledger
def convert_ledger(op_graph) -> dict:
    """One path's int8 → float ledger: count and bytes of the converts
    outside every kernel (each writes its float tensor to memory), and
    each of them."""
    mat = [r for r in op_graph.converts() if not r.in_kernel]
    return {
        "count": len(mat),
        "bytes": sum(r.nbytes for r in mat),
        "materialized": [{"shape": list(r.shape), "dtype": r.dtype}
                         for r in mat],
    }


def is_cache_dequant(record, artifact) -> bool:
    """A convert whose trailing dims are a whole cache ring ([..., S, Hkv,
    hd]) — the full-ring dequant. Weight dequants ([K, N]) never match:
    the ledger's totals pin them."""
    dims = tuple(getattr(artifact, "cache_payload_dims", ()) or ())
    return (bool(dims) and len(record.shape) >= len(dims)
            and tuple(record.shape[-len(dims):]) == dims)


def collective_table(op_graph) -> dict[str, list]:
    """{kind: [count, total result bytes]} of a path's collectives."""
    table: dict[str, list] = {}
    for kind, _, _, nbytes in op_graph.collectives:
        row = table.setdefault(kind, [0, 0])
        row[0] += 1
        row[1] += nbytes
    return table


def pool_collective_hits(op_graph, artifact) -> list[dict]:
    """Collectives whose result is a whole pool leaf (global or per-rank
    shape, rank >= 2). The paged pool's ``page_table`` is left out, as in
    the reference: replicated, read-only in every dispatch, tiny, and its
    ``[slots, pages_per_slot]`` shape collides with reduction lattices."""
    targets = {
        (dt, tuple(dims))
        for dt, dims in (artifact.cache_leaves_global
                         + artifact.cache_leaves_local)
        if len(dims) >= 2
    } - {(dt, tuple(dims)) for dt, dims in artifact.page_table_shapes}
    return [{"op": kind, "where": f"#{i}", "type": type_str(dt, shape),
             "bytes": nbytes}
            for i, (kind, dt, shape, nbytes) in enumerate(op_graph.collectives)
            if (dt, tuple(shape)) in targets]


def inplace_info(op_graph, artifact) -> dict:
    """The in-place audit of one path: the pool leaves that changed their
    storage or address (or vanished) across the call, the pool-sized
    tensors ops outside kernels allocated, and the engine-held views they
    wrote."""
    rebound = sorted(name for name, state in op_graph.pool_before.items()
                     if op_graph.pool_after.get(name) != state)
    sizes = {(dt, tuple(dims)) for dt, dims in artifact.pool_payload}
    copies: list = []
    views: set = set()
    for r in op_graph.records:
        if r.kernel is not None:
            continue
        for t in r.allocated:
            if (t.dtype, t.shape) in sizes:
                copies.append(type_str(t.dtype, t.shape))
        for t in r.mutated:
            if t.storage in op_graph.views:
                views.add(op_graph.views[t.storage])
    return {"leaves": len(op_graph.pool_before), "rebound": rebound,
            "copies": copies, "views": sorted(views),
            "ok": not rebound and not copies and not views}


# ============================================================== known debt
def _debt_entries(contract: Optional[dict], rule: str, jit: str) -> list[dict]:
    if not contract:
        return []
    return [d for d in contract.get("known_debt", [])
            if d.get("rule") == rule and d.get("jit") in (jit, "*")]


def _debt_covers(entries: list[dict], key: str, value) -> bool:
    return any(d.get(key) in (value, "*") for d in entries)


# ============================================================== core rules
@register_rule("dtype-ledger")
def rule_dtype_ledger(graph, contract) -> list[Finding]:
    out: list[Finding] = []
    for name, art in graph.jits.items():
        if art.graph is None:
            continue
        dequants: dict = {}
        for r in art.graph.converts():
            if not r.in_kernel and is_cache_dequant(r, art):
                dequants.setdefault((r.shape, r.dtype), []).append(r.op)
        for (rshape, rdtype), ops in sorted(dequants.items()):
            shape = "x".join(map(str, rshape))
            what = (f"{len(ops)} int8 -> {rdtype} convert(s) "
                    f"({', '.join(sorted(set(ops)))}) materialize a full "
                    f"[{shape}] dequant")
            if art.kind == "decode":
                out.append(Finding(
                    "dtype-ledger", "error", name, shape,
                    f"{what} on the decode path outside every kernel — "
                    f"eager torch fuses nothing, so int8 KV must only be "
                    f"converted inside a kernel (the scale-fold in "
                    f"registers)",
                ))
                continue
            debt = _debt_entries(contract, "dtype-ledger", name)
            if _debt_covers(debt, "shape", list(rshape)):
                out.append(Finding(
                    "dtype-ledger", "info", name, shape,
                    f"{what}, pinned as known_debt (the chunked prefill's "
                    f"eager attention)",
                ))
            else:
                out.append(Finding(
                    "dtype-ledger", "error", name, shape,
                    f"{what}, not pinned in the contract's known_debt — run "
                    f"--update only if this materialization is intentional",
                ))
        if contract:
            want = contract.get("jits", {}).get(name, {}).get("int8_converts")
            if want is not None:
                led = convert_ledger(art.graph)
                for k in ("count", "bytes"):
                    if led[k] != want.get(k):
                        out.append(Finding(
                            "dtype-ledger", "error", name, k,
                            f"int8-convert ledger drift: {k} = {led[k]} but "
                            f"the contract pins {want.get(k)} — the int8 path "
                            f"changed shape; rerun with --update if "
                            f"intentional",
                        ))
    return out


@register_rule("collective-budget")
def rule_collective_budget(graph, contract) -> list[Finding]:
    out: list[Finding] = []
    tp = bool(graph.mesh_shape) and graph.mesh_shape[-1] > 1
    for name, art in graph.jits.items():
        if art.graph is None or art.kind == "kernel":
            continue
        table = collective_table(art.graph)
        debt = _debt_entries(contract, "collective-budget", name)
        for hit in pool_collective_hits(art.graph, art):
            if tp and not _debt_covers(debt, "type", hit["type"]):
                out.append(Finding(
                    "collective-budget", "error", name, hit["where"],
                    f"{hit['op']} returns a whole cache-pool leaf "
                    f"{hit['type']} ({hit['bytes']} B a rank) — the pool "
                    f"must stay shard-resident under TP; pin as known_debt "
                    f"only with a ROADMAP item to remove it",
                ))
            elif tp:
                out.append(Finding(
                    "collective-budget", "info", name, hit["where"],
                    f"pool-leaf {hit['op']} {hit['type']} covered by "
                    f"known_debt",
                ))
        if contract:
            want = contract.get("jits", {}).get(name, {}).get("collectives")
            if want is not None:
                for op in sorted(set(table) | set(want)):
                    got_c, got_b = table.get(op, [0, 0])
                    want_c, want_b = want.get(op, [0, 0])
                    if (got_c, got_b) != (want_c, want_b):
                        direction = ("new collective traffic"
                                     if got_b > want_b or got_c > want_c
                                     else "less traffic than pinned (a win "
                                          "— record it)")
                        out.append(Finding(
                            "collective-budget", "error", name, op,
                            f"{op}: {got_c} ops / {got_b} B vs contract "
                            f"{want_c} ops / {want_b} B — {direction}; "
                            f"run --update to re-pin",
                        ))
    return out


@register_rule("donation-audit")
def rule_donation_audit(graph, contract) -> list[Finding]:
    out: list[Finding] = []
    for name, art in graph.jits.items():
        if art.graph is None or not art.graph.pool_before:
            continue
        info = inplace_info(art.graph, art)
        for leaf in info["rebound"]:
            out.append(Finding(
                "donation-audit", "error", name, leaf,
                f"pool leaf {leaf!r} left its storage during the call — the "
                f"pool must be written in place: a captured CUDA graph "
                f"holds the old address and its replay would write a dead "
                f"buffer",
            ))
        for t in sorted(set(info["copies"])):
            n = info["copies"].count(t)
            out.append(Finding(
                "donation-audit", "error", name, t,
                f"{n} op(s) outside every kernel allocate a {t} tensor, a "
                f"pool payload leaf's size — a copy of the pool each call",
            ))
        if info["views"]:
            debt = _debt_entries(contract, "donation-audit", name)
            leaves = ", ".join(info["views"])
            if _debt_covers(debt, "where", "dense view"):
                out.append(Finding(
                    "donation-audit", "info", name, "dense view",
                    f"the paged dense view ({leaves}) pinned as known_debt",
                ))
            else:
                out.append(Finding(
                    "donation-audit", "error", name, "dense view",
                    f"ops outside every kernel write the paged engine's "
                    f"dense view ({leaves}), a second copy of the KV "
                    f"payload — not pinned in the contract's known_debt",
                ))
    want = (contract or {}).get("pool")
    got = getattr(graph, "pool_leaves", None)
    if want is not None and got is not None and want != got:
        for leaf in sorted(set(want) | set(got)):
            if want.get(leaf) != got.get(leaf):
                out.append(Finding(
                    "donation-audit", "error", "", f"pool/{leaf}",
                    f"pool leaf {leaf!r} is {got.get(leaf)} but the "
                    f"contract pins {want.get(leaf)} — the pool layout "
                    f"changed; --update to re-pin",
                ))
    live = getattr(graph, "pool_ptrs", None) or {}
    for key, ptrs in sorted((getattr(graph, "captured_ptrs", None)
                             or {}).items()):
        for leaf, ptr in sorted(ptrs.items()):
            if live.get(leaf) != ptr:
                out.append(Finding(
                    "donation-audit", "error", f"{key[0]}[{key[1]}]", leaf,
                    f"the CUDA graph of {key} captured {leaf!r} at "
                    f"{ptr:#x}, but the live pool's is at "
                    f"{live.get(leaf, 0):#x} — its replays write a dead "
                    f"buffer",
                ))
    return out


@register_rule("recompilation-guard")
def rule_recompilation_guard(graph, contract) -> list[Finding]:
    out: list[Finding] = []
    warm = {tuple(s) for s in graph.warmup_shapes}
    for jit, dim in sorted(set(graph.dispatch_shapes) - warm):
        out.append(Finding(
            "recompilation-guard", "error", jit, str(dim),
            f"dispatchable shape ({jit}, {dim}) is not covered by "
            f"engine.warmup() — a live step would capture a CUDA graph "
            f"mid-traffic; extend warmup_shapes() or round the dispatch "
            f"choice onto the warmed set",
        ))
    captured = getattr(graph, "captured", None)
    if captured is not None:
        for jit, dim in sorted(set(captured) - warm):
            out.append(Finding(
                "recompilation-guard", "error", jit, str(dim),
                f"the engine captured a graph for ({jit}, {dim}), which is "
                f"not a warmup shape",
            ))
        if getattr(graph, "warmed", False):
            for jit, dim in sorted(warm - set(captured)):
                out.append(Finding(
                    "recompilation-guard", "error", jit, str(dim),
                    f"warmup() ran but ({jit}, {dim}) has no captured graph "
                    f"— its first dispatch would capture mid-traffic",
                ))
    if contract and "warmup_shapes" in contract:
        want = {tuple(s) for s in contract["warmup_shapes"]}
        for jit, dim in sorted(warm - want):
            out.append(Finding(
                "recompilation-guard", "error", str(jit), str(dim),
                f"new warmup shape ({jit}, {dim}) not in the contract — the "
                f"captured-graph set grew; --update to accept it",
            ))
        for jit, dim in sorted(want - warm):
            out.append(Finding(
                "recompilation-guard", "error", str(jit), str(dim),
                f"contract shape ({jit}, {dim}) is no longer captured at "
                f"warmup — the warmed set shrank; --update to re-pin",
            ))
        for jit, dim in sorted(want - set(graph.dispatch_shapes)):
            out.append(Finding(
                "recompilation-guard", "error", str(jit), str(dim),
                f"contract shape ({jit}, {dim}) is no dispatch's any more "
                f"— warmup captures a graph no step replays",
            ))
    return out


def _axis_entry(spec, dim: int):
    """The axis assignment of ``spec`` at ``dim`` (None past its length:
    trailing dims replicate)."""
    if spec is None:
        return None
    entries = tuple(spec)
    return entries[dim] if dim < len(entries) else None


@register_rule("scale-coupling")
def rule_scale_coupling(graph, contract) -> list[Finding]:
    out: list[Finding] = []
    leaves = graph.param_leaves or {}
    for q_path, s_path in graph.scale_pairs or []:
        q = leaves.get(q_path)
        s = leaves.get(s_path)
        if q is None:
            continue
        if s is None:
            out.append(Finding(
                "scale-coupling", "error", "params", q_path,
                f"int8 payload {q_path} has no scale leaf at {s_path} — "
                f"a QTensor without its scale cannot dequantize",
            ))
            continue
        q_axis = _axis_entry(q.get("spec"), len(q["shape"]) - 1)
        s_axis = _axis_entry(s.get("spec"), len(s["shape"]) - 1)
        per_tensor = not s["shape"] or s["shape"][-1] == 1
        if per_tensor:
            if s_axis is not None:
                out.append(Finding(
                    "scale-coupling", "error", "params", s_path,
                    f"per-tensor scale {s_path} is sharded on {s_axis!r} — "
                    f"a size-1 scale must replicate",
                ))
            continue
        if q_axis != s_axis:
            out.append(Finding(
                "scale-coupling", "error", "params", s_path,
                f"scale out-feature axis {s_axis!r} != payload out-feature "
                f"axis {q_axis!r} for {q_path} — a TP shard would gather "
                f"foreign scales to dequantize its own columns",
            ))
    # KV cache: scale / v_err leaves follow their payload's slot + head axes
    cache = graph.cache_spec_leaves or {}
    for pay_name, follow_name in (("k", "k_scale"), ("v", "v_scale"),
                                  ("v", "v_err")):
        pay = cache.get(f"/{pay_name}")
        fol = cache.get(f"/{follow_name}")
        if pay is None or fol is None:
            continue
        for dim, what in ((1, "slot"), (3, "head")):
            pa = _axis_entry(pay.get("spec"), dim)
            fa = _axis_entry(fol.get("spec"), dim)
            if (dim < len(fol["shape"]) and fol["shape"][dim] > 1
                    and pa != fa):
                out.append(Finding(
                    "scale-coupling", "error", "cache", f"/{follow_name}",
                    f"cache {follow_name} {what} axis {fa!r} != payload "
                    f"{pay_name} {what} axis {pa!r} — scales must live on "
                    f"their payload's shard",
                ))
    return out
