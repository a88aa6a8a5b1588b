"""The port's graph linter on real recorded graphs (mirrors
``tests/test_lint_graph.py``).

Builds the smoke serving engine per recipe on the CPU, records its four
paths on meta copies (``extract.build_graph``: nothing runs) and asserts
that the committed contracts still describe them exactly — the check
``python -m repro_torch.analysis.lint --check`` runs — and that the rules
fire when a contract is perturbed or a fault is planted in the engine (an
eager decode dequant, a reassigned pool leaf, an unwarmed dispatch shape).
The ``-tp`` recipes run as rank 0 of a fake 2x4 world
(``launch.dryrun.fake_mesh``, which refuses to start beside another
process group: this file opens none). Each stem's engine fingerprint,
warmup set and debts are held to the JAX package's contract JSON, read as
files. Last, ``serve(lint=True)`` on the CPU smoke config.
"""
import copy
import json
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.analysis.lint import (
    build_graph,
    graph_from_engine,
    run_rules,
    type_bytes,
)
from repro_torch.analysis.lint import contracts as c
from repro_torch.analysis.lint.cli import DEFAULT_RECIPES, LINT_PAGE_SIZE
from repro_torch.models import layers
from repro_torch.pipeline.recipes import (
    contract_stem,
    lint_mesh_shape,
    split_recipe_flags,
)
from repro_torch.serving import ServingEngine

ENGINE_JITS = ("prefill", "prefill_multi", "decode", "decode_horizon")
JAX_CONTRACTS = (Path(__file__).resolve().parents[1] / "src" / "repro"
                 / "analysis" / "lint" / "contracts")
#: (stem, rule, path) debts the port has and the JAX package has not, or
#: the reverse, each with its reason
_VIEW = ("the paged engine's dense view of the pool, written outside any "
         "kernel (ROADMAP Parked 8); the reference gathers its pages inside "
         "each jit, where XLA's buffers are no second copy it can see")
DEBT_DIFFERENCES = {
    (stem, "donation-audit", jit): _VIEW
    for stem in ("serve-w8a16+paged", "serve-w8a8-kv8+paged",
                 "serve-w8a16-tp.2x4+paged", "serve-w8a8-kv8-tp.2x4+paged")
    for jit in ENGINE_JITS}


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


def _stem(recipe):
    return contract_stem(recipe, lint_mesh_shape(recipe))


@pytest.fixture(scope="module")
def kv8_graph():
    # build_graph's defaults are the geometry the contracts pin
    return build_graph("serve-w8a8-kv8")


@pytest.fixture(scope="module")
def kv8_engine():
    qm = repro_torch.quantize("qwen2-0.5b-smoke", recipe="serve-w8a8-kv8",
                              device="cpu")
    return ServingEngine(qm.model, qm.params, qm.cfg, num_slots=4, max_len=32,
                         prefill_chunk=8, decode_horizon=8, device="cpu")


def test_committed_contract_still_holds(kv8_graph):
    contract = c.load_contract("serve-w8a8-kv8")
    assert contract is not None, "contract file missing from the package"
    findings = run_rules(kv8_graph, contract)
    assert _errors(findings) == [], [f.format() for f in _errors(findings)]


def test_fresh_snapshot_matches_committed_contract(kv8_graph):
    assert c.diff_contracts(c.load_contract("serve-w8a8-kv8"),
                            c.snapshot(kv8_graph)) == []


def test_graph_covers_all_serve_paths(kv8_graph):
    for name in ENGINE_JITS:
        g = kv8_graph.jits[name].graph
        assert g is not None and g.records
    kernels = {n for n, a in kv8_graph.jits.items() if a.kind == "kernel"}
    assert kernels == {"fused_decode", "kv_attention_decode", "qmatmul_w8a16",
                       "qmatmul_w8a8", "quantize_act"}
    # the decode paths go through the fused kernel and the W8A8 GEMMs: one
    # node a kernel call (2 layers, 7 projections, q/k/v and gate/up each
    # reading one quantized input)
    decode = kv8_graph.jits["decode"].graph.kernel_counts()
    assert decode["fused_decode"] == 2
    assert kv8_graph.jits["decode_horizon"].graph.kernel_counts()[
        "fused_decode"] == 16


def test_every_pool_leaf_is_audited(kv8_graph):
    # kv8 pool: k, k_scale, v, v_scale, kpos, pos — each kept in place
    for name in ENGINE_JITS:
        g = kv8_graph.jits[name].graph
        assert sorted(g.pool_before) == ["k", "k_scale", "kpos", "pos", "v",
                                         "v_scale"]
        assert g.pool_after == g.pool_before


def test_dispatch_shapes_closed_under_warmup(kv8_graph):
    assert set(kv8_graph.dispatch_shapes) <= set(kv8_graph.warmup_shapes)


def test_perturbed_contract_is_caught(kv8_graph):
    contract = copy.deepcopy(c.load_contract("serve-w8a8-kv8"))
    contract["warmup_shapes"] = contract["warmup_shapes"][:-1]
    contract["jits"]["decode"]["int8_converts"]["count"] += 1
    contract["known_debt"] = []          # un-pin the prefill cache dequants
    rules_fired = {f.rule for f in _errors(run_rules(kv8_graph, contract))}
    assert {"recompilation-guard", "dtype-ledger"} <= rules_fired


def test_w8a16_contract_has_no_debt():
    assert c.load_contract("serve-w8a16")["known_debt"] == []


def test_tp_contract_holds_under_the_fake_world():
    graph = build_graph("serve-w8a8-kv8-tp", mesh_shape=(2, 4))
    contract = c.load_contract("serve-w8a8-kv8-tp.2x4")
    findings = run_rules(graph, contract)
    assert _errors(findings) == [], [f.format() for f in _errors(findings)]
    assert c.diff_contracts(contract, c.snapshot(graph)) == []
    # the logical collectives were recorded, each with its result's type
    events = graph.jits["decode"].graph.collectives
    assert {e[0] for e in events} == {"all-gather", "all-reduce"}
    assert all(e[3] == type_bytes(e[1], e[2]) for e in events)
    # the pool is this rank's: 2 of 4 slots (data 2); KV heads whole (2
    # heads do not divide model 4)
    assert graph.pool_leaves["k"] == "int8[2,2,32,2,16]"
    assert graph.param_leaves["/blocks/attn/wq/scale"]["spec"] is not None


def test_contract_roundtrip(tmp_path, monkeypatch, kv8_graph):
    monkeypatch.setattr(c, "CONTRACT_DIR", str(tmp_path))
    snap = c.snapshot(kv8_graph)
    c.save_contract("roundtrip", snap)
    assert c.load_contract("roundtrip") == snap
    assert c.load_contract("missing") is None


def test_engine_and_kernel_hooks_record_op_graphs(kv8_engine):
    """``lowered_serve_jits`` runs the four paths masked on the engine's own
    tensors (the pool's bookkeeping unchanged); ``lower_serving_kernels``
    records each registered op on meta tensors."""
    from repro_torch.kernels import lower_serving_kernels

    book = {k: kv8_engine.pool.cache[k].clone() for k in ("kpos", "pos")}
    graphs = kv8_engine.lowered_serve_jits()
    assert sorted(graphs) == sorted(ENGINE_JITS)
    assert graphs["decode_horizon"].kernel_counts("torch")[
        "fused_decode"] == 16
    assert all(torch.equal(book[k], kv8_engine.pool.cache[k]) for k in book)
    kern = lower_serving_kernels(device="meta")
    assert {n: g.kernel_counts() for n, g in kern.items()} == {
        "fused_decode": {"fused_decode": 1},
        "kv_attention_decode": {"kv_attention": 1},
        "qmatmul_w8a16": {"qmatmul_w8a16": 1},
        "qmatmul_w8a8": {"qmatmul_w8a8": 1},
        "quantize_act": {"quantize_act": 1}}


# ------------------------------------------------------ planted faults
def _lint(engine):
    graph = graph_from_engine(engine, recipe="serve-w8a8-kv8",
                              include_kernels=False)
    return _errors(run_rules(graph, c.load_contract("serve-w8a8-kv8")))


def test_planted_decode_dequant_is_caught(kv8_engine, monkeypatch):
    real = layers.fused_decode

    def planted(q, cache_k, *a, **kw):
        cache_k.to(torch.float32)        # the whole ring, outside a kernel
        return real(q, cache_k, *a, **kw)

    # (the engine unplanted lints clean: the unwarmed-shape test below
    # finds its one planted error alone)
    monkeypatch.setattr(layers, "fused_decode", planted)
    errs = _lint(kv8_engine)
    hits = [f for f in errs if f.rule == "dtype-ledger"
            and f.where == "4x32x2x16"]
    assert {f.jit for f in hits} == {"decode", "decode_horizon"}


def test_planted_reassigned_pool_leaf_is_caught(kv8_engine, monkeypatch):
    real = ServingEngine._decode_masked

    def planted(self, cache, tokens, active):
        out = real(self, cache, tokens, active)
        cache["pos"] = cache["pos"].clone()     # rebinds, not in place
        return out

    monkeypatch.setattr(ServingEngine, "_decode_masked", planted)
    errs = [f for f in _lint(kv8_engine) if f.rule == "donation-audit"]
    assert {(f.jit, f.where) for f in errs} == {("decode", "pos"),
                                               ("decode_horizon", "pos")}
    assert all("dead buffer" in f.message for f in errs)


def test_planted_unwarmed_dispatch_shape_is_caught(kv8_engine, monkeypatch):
    shapes = kv8_engine.dispatch_shapes()
    monkeypatch.setattr(kv8_engine, "dispatch_shapes",
                        lambda: shapes | {("decode_horizon", 3)})
    errs = _lint(kv8_engine)
    assert [(f.rule, f.jit, f.where) for f in errs] == [
        ("recompilation-guard", "decode_horizon", "3")]


# ------------------------------------------------ against the JAX package
@pytest.mark.parametrize("recipe", DEFAULT_RECIPES)
def test_contract_matches_the_jax_packages(recipe):
    """The port's eight stems are the reference's: the same engine
    fingerprint and warmup set, and the same (rule, path) debts but for
    ``DEBT_DIFFERENCES``."""
    stem = _stem(recipe)
    with open(JAX_CONTRACTS / f"{stem}.json") as f:
        jax_c = json.load(f)
    port = c.load_contract(stem)
    assert port["engine"] == jax_c["engine"]
    assert port["warmup_shapes"] == jax_c["warmup_shapes"]
    assert port["mesh"] == jax_c["mesh"] and port["recipe"] == recipe
    pairs = {(d["rule"], d["jit"]) for d in port["known_debt"]}
    jax_pairs = {(d["rule"], d["jit"]) for d in jax_c["known_debt"]}
    differ = {(r, j) for s, r, j in DEBT_DIFFERENCES if s == stem}
    assert pairs ^ jax_pairs == differ
    assert all(d["why"] for d in port["known_debt"])
    base, flags = split_recipe_flags(recipe)
    assert (port["engine"]["page_size"] == LINT_PAGE_SIZE) == bool(flags)


# ------------------------------------------------------ serve --lint
def test_serve_lint_passes_and_changes_no_token(capsys):
    cfg = dict(smoke=True, device="cpu", trace=6, quantize="w8a8", kv_bits=8)
    plain = repro_torch.serve(repro_torch.ServeConfig(**cfg))
    capsys.readouterr()
    linted = repro_torch.serve(repro_torch.ServeConfig(lint=True, **cfg))
    out = capsys.readouterr().out
    assert "--lint: pass" in out and "0 error(s)" in out
    assert {r: v.tokens for r, v in linted.results.items()} == {
        r: v.tokens for r, v in plain.results.items()}
    # every counter but the straggler monitor's, which reads the wall clock
    assert ({k: v for k, v in linted.stats.items() if k != "straggler_steps"}
            == {k: v for k, v in plain.stats.items()
                if k != "straggler_steps"})
