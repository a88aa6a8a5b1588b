"""The graph linter's entry points (port of ``repro.analysis.lint.cli``).

    # regenerate the checked-in contracts (after an INTENTIONAL change of a
    # serve path; review the printed diff before committing):
    python -m repro_torch.analysis.lint --update

    # the gate: exit 1 on any contract drift or rule violation
    python -m repro_torch.analysis.lint --check

    # one recipe, with a JSON report and a markdown summary:
    python -m repro_torch.analysis.lint --check --recipes serve-w8a16-tp \\
        --report lint_report.json --summary summary.md

    python -m repro_torch.analysis.lint --list-rules

Exit codes: 0 clean, 1 a violation or drift under ``--check``, 2 an
unknown recipe or flag. Every graph is recorded on the CPU from the smoke
model (``extract.build_graph``); the ``-tp`` recipes lint as rank 0 of a
fake 2x4 world, which needs no devices. ``lint_engine`` lints a live
engine (``serve --lint``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

DEFAULT_RECIPES = (
    "serve-w8a16",
    "serve-w8a8-kv8",
    "serve-w8a16-tp",
    "serve-w8a8-kv8-tp",
    # +paged: the same recipes through the page-table KV pool
    "serve-w8a16+paged",
    "serve-w8a8-kv8+paged",
    "serve-w8a16-tp+paged",
    "serve-w8a8-kv8-tp+paged",
)

# the paged lint geometry: ring 32 / page 8 -> 4 pages per slot table
LINT_PAGE_SIZE = 8


def _severity_counts(findings) -> dict:
    out = {"error": 0, "warn": 0, "info": 0}
    for f in findings:
        out[f.severity] += 1
    return out


def format_findings(findings) -> str:
    return "\n".join("  " + f.format() for f in findings)


def lint_graph(graph, contract: Optional[dict]):
    """Run every rule over one extracted graph; a stale engine fingerprint
    surfaces as a finding rather than an exception, so the report always
    renders."""
    from .rules import Finding, run_rules

    pre: list = []
    if contract is not None and contract.get("engine") != graph.engine:
        pre.append(Finding(
            "contract", "error", "", "engine",
            f"engine fingerprint drifted from the contract: contract "
            f"{contract.get('engine')} vs graph {graph.engine} — the "
            f"contract no longer describes this serving geometry; "
            f"regenerate with --update",
        ))
    return pre + run_rules(graph, contract)


def lint_recipe(recipe: str, *, update: bool = False,
                arch: str = "qwen2-0.5b") -> dict:
    """Extract and lint one recipe against its checked-in contract (or
    regenerate the contract when ``update``). Returns a JSON-able result:
    {recipe, stem, mesh, action, findings, counts, diff, ok}."""
    from ...pipeline.recipes import (
        contract_stem,
        lint_mesh_shape,
        split_recipe_flags,
    )
    from . import contracts
    from .extract import build_graph
    from .rules import Finding

    base, flags = split_recipe_flags(recipe)
    mesh_shape = lint_mesh_shape(base)
    stem = contract_stem(recipe, mesh_shape)
    graph = build_graph(
        base, mesh_shape, arch=arch,
        page_size=LINT_PAGE_SIZE if "paged" in flags else None,
    )
    graph.recipe = recipe        # contracts record the flagged name
    old = contracts.load_contract(stem)
    diff: list = []
    if update:
        fresh = contracts.snapshot(graph)
        diff = contracts.diff_contracts(old, fresh)
        path = contracts.save_contract(stem, fresh)
        findings = lint_graph(graph, fresh)
        action = f"wrote {path}"
    else:
        findings = lint_graph(graph, old)
        if old is None:
            findings.insert(0, Finding(
                "contract", "error", "", stem,
                f"no contract at {contracts.contract_path(stem)} — generate "
                f"one with: python -m repro_torch.analysis.lint --update "
                f"--recipes {recipe}",
            ))
        else:
            fresh = contracts.snapshot(graph)
            diff = contracts.diff_contracts(old, fresh)
            # the debt ratchet: known_debt may shrink or hold, never grow
            for e in contracts.debt_growth(old, fresh):
                findings.append(Finding(
                    "known-debt-growth", "error", e.get("jit", ""),
                    e.get("rule", ""),
                    f"known_debt grew: {json.dumps(e, sort_keys=True)} — "
                    f"fix the graph, or (only if the regression is "
                    f"deliberate) --update and justify the new entry",
                ))
        action = "checked"
    counts = _severity_counts(findings)
    return {
        "recipe": recipe,
        "stem": stem,
        "mesh": "x".join(map(str, mesh_shape)) if mesh_shape else None,
        "action": action,
        "findings": [dataclasses.asdict(f) for f in findings],
        "counts": counts,
        "diff": diff,
        "ok": counts["error"] == 0,
        "_findings": findings,   # live objects for printing; not reported
    }


def lint_engine(engine, recipe: str, *, verbose: bool = True,
                graph=None) -> list:
    """Lint a LIVE ``ServingEngine`` (the ``serve --lint`` path): its four
    paths run masked on its own tensors at its own tier (``graph_from_engine
    (live=True)``). Where the engine's geometry is a checked-in contract's,
    every budget of that contract applies; otherwise (custom slots, chunk,
    horizon, a paged pool, a mesh, a recipe with no contract) the
    structural rules run alone, with the port's structural debts
    (``contracts.STRUCTURAL_DEBT``), so a one-off serving config never
    trips on a budget pin. ``graph``: an already extracted live graph."""
    from ...pipeline.recipes import contract_stem
    from ...pipeline.state import RecipeError
    from . import contracts
    from .extract import graph_from_engine
    from .rules import run_rules

    if graph is None:
        graph = graph_from_engine(engine, recipe=recipe, live=True)
    try:
        stem = contract_stem(recipe, graph.mesh_shape)
        contract = contracts.load_contract(stem)
    except RecipeError:          # no built-in recipe: no contract
        stem, contract = recipe, None
    pinned = contract is not None and contract.get("engine") == graph.engine
    if not pinned:
        contract = contracts.structural_contract()
    findings = run_rules(graph, contract)
    if verbose:
        counts = _severity_counts(findings)
        mode = (f"contract {stem}" if pinned else
                "structural rules only — no contract pins this engine's "
                "geometry")
        print(f"graph lint ({mode}): {counts['error']} error(s), "
              f"{counts['warn']} warning(s), {counts['info']} info")
        txt = format_findings(findings)
        if txt:
            print(txt)
    return findings


def write_summary(path: str, results: list[dict], mode: str) -> None:
    with open(path, "a") as f:
        f.write(f"## Graph lint ({mode})\n\n")
        f.write("| recipe | mesh | errors | warns | contract drift |\n")
        f.write("|---|---|---|---|---|\n")
        for r in results:
            drift = "; ".join(r["diff"][:4]) or "none"
            if len(r["diff"]) > 4:
                drift += f" (+{len(r['diff']) - 4} more)"
            f.write(f"| {r['recipe']} | {r['mesh'] or '-'} | "
                    f"{r['counts']['error']} | {r['counts']['warn']} | "
                    f"{drift} |\n")
        f.write("\n")
        errs = [f for r in results for f in r["findings"]
                if f["severity"] == "error"]
        if errs:
            f.write("### Errors\n\n")
            for e in errs:
                loc = f"{e['jit']}:{e['where']}" if e["where"] else e["jit"]
                f.write(f"- **{e['rule']}** @ `{loc}`: {e['message']}\n")
            f.write("\n")
        drifted = [r for r in results if r["diff"]]
        if drifted:
            f.write("### Contract drift\n\n")
            for r in drifted:
                f.write(f"**{r['recipe']}** ({r['stem']}):\n")
                for line in r["diff"]:
                    f.write(f"- {line}\n")
                f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the graph linter: contracts over the port's recorded "
                    "int8 serve paths")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--check", action="store_true",
                      help="lint against the checked-in contracts; exit 1 "
                           "on any error or contract drift")
    mode.add_argument("--update", action="store_true",
                      help="regenerate the contract snapshots from the "
                           "current graphs (review the printed diff!)")
    mode.add_argument("--list-rules", action="store_true",
                      help="print the registered rule names and exit")
    ap.add_argument("--recipes", default=",".join(DEFAULT_RECIPES),
                    help="comma-separated recipe names "
                         f"(default: {','.join(DEFAULT_RECIPES)})")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="smoke arch the graphs are extracted from")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the full findings as JSON")
    ap.add_argument("--summary", default=None, metavar="PATH",
                    help="append a markdown summary table")
    args = ap.parse_args(argv)

    if args.list_rules:
        from .rules import list_rules

        for name in list_rules():
            print(name)
        return 0

    from ...pipeline.state import RecipeError

    results = []
    ok = True
    for recipe in [r for r in args.recipes.split(",") if r]:
        try:
            res = lint_recipe(recipe.strip(), update=args.update,
                              arch=args.arch)
        except RecipeError as e:
            print(f"== {recipe.strip()}: {e}", file=sys.stderr)
            return 2
        findings = res.pop("_findings")
        results.append(res)
        ok = ok and res["ok"]
        where = f" [{res['mesh']}]" if res["mesh"] else ""
        print(f"== {res['recipe']}{where}: {res['action']} — "
              f"{res['counts']['error']} error(s), "
              f"{res['counts']['warn']} warning(s), "
              f"{res['counts']['info']} info")
        txt = format_findings(findings)
        if txt:
            print(txt)
        for line in res["diff"]:
            print(f"  drift: {line}")

    if args.report:
        with open(args.report, "w") as f:
            json.dump({"mode": "update" if args.update else "check",
                       "ok": ok, "recipes": results}, f, indent=2)
            f.write("\n")
    if args.summary:
        write_summary(args.summary, results,
                      "update" if args.update else "check")
    if args.check and not ok:
        print("graph lint FAILED — fix the violation or, if the change is "
              "intentional, run `python -m repro_torch.analysis.lint "
              "--update` and commit the contract diff", file=sys.stderr)
        return 1
    return 0
