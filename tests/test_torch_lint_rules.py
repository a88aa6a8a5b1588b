"""The port's graph linter on hand-built miniatures (mirrors
``tests/test_lint_rules.py``): each of the five rules gets a graph that
passes and a broken twin it flags with a message naming the path and the
place. Op graphs are recorded from tiny eager functions
(``graph_model.GraphRecorder``), a kernel scope opened by hand where a
kernel's plain version would run. Also: the recorder itself (implicit
promotion is a convert; a convert inside a kernel scope is exempt;
``resolve`` hands out the impl itself with no recorder open, a scoped
wrapper with one), ``graph_diag``, the contracts' diff and ratchet, and
the recipe helpers against the JAX package's.
"""
import itertools

import pytest
import torch

from repro.pipeline import recipes as jax_recipes

from repro_torch.analysis import graph_diag
from repro_torch.analysis.lint import (
    Finding,
    GraphRecorder,
    OpGraph,
    register_rule,
    run_rules,
    type_bytes,
)
from repro_torch.analysis.lint.contracts import (
    debt_growth,
    diff_contracts,
    structural_contract,
)
from repro_torch.analysis.lint.extract import JitArtifact, LintGraph
from repro_torch.analysis.lint.graph_model import (
    pool_state,
    record_graph,
    type_str,
)
from repro_torch.analysis.lint.rules import convert_ledger, is_cache_dequant
from repro_torch.kernels import dispatch
from repro_torch.kernels.qmatmul_w8a16.ops import qmatmul_w8a16
from repro_torch.pipeline import recipes as torch_recipes

# miniature cache geometry: one ring is [S, H, hd] = [8, 2, 4]
CACHE_DIMS = (8, 2, 4)


def _graph(jits, mesh_shape=None, **kw):
    return LintGraph(recipe="mini", mesh_shape=mesh_shape, engine={},
                     jits=jits, **kw)


def _artifact(name, kind, **kw):
    kw.setdefault("cache_payload_dims", CACHE_DIMS)
    return JitArtifact(name=name, kind=kind, **kw)


def _record(fn, *args, kernel=None, pool=None, views=None):
    """Record ``fn(*args)``, inside a kernel scope named ``kernel`` if
    given; ``pool`` a {leaf: tensor} read before and after."""
    g = OpGraph("t")
    g.views = {t.untyped_storage()._cdata: n
               for n, t in (views or {}).items()}
    if pool is not None:
        g.pool_before = pool_state(pool)
    rec = GraphRecorder(g)
    with rec:
        if kernel is None:
            fn(*args)
        else:
            with rec.kernel_scope(kernel, "torch", args, {}):
                fn(*args)
    if pool is not None:
        g.pool_after = pool_state(pool)
    return g


def _ring():
    return torch.zeros(CACHE_DIMS, dtype=torch.int8)


def _dequant(k, s):                    # dequantize-multiply, one aten.mul
    return (k * s).sum()


# ------------------------------------------------------------ graph_model
def test_type_bytes_and_unknown_dtype_raises():
    assert type_bytes(torch.bfloat16, (4, 8)) == 64
    assert type_bytes("int8", ()) == 1
    assert type_str(torch.int8, (2, 3)) == "int8[2,3]"
    with pytest.raises(ValueError, match="no width"):
        type_bytes("float8_e9m9", (4,))


def test_implicit_promotion_is_a_convert():
    # an int8 tensor times a float scale: ONE aten.mul.Tensor, no cast op
    g = _record(_dequant, _ring(), torch.ones(CACHE_DIMS[:-1] + (1,)))
    (c,) = g.converts()
    assert c.op == "aten.mul.Tensor" and c.shape == CACHE_DIMS
    assert c.dtype == "float32" and not c.in_kernel
    assert c.nbytes == 8 * 2 * 4 * 4
    # an explicit cast is one too; an int8 -> int8 op or a float op is not
    g = _record(lambda k: (k.to(torch.float32), k + k, k.float() * 2),
                _ring())
    assert [c.op for c in g.converts()] == ["aten._to_copy.default",
                                             "aten._to_copy.default"]


def test_convert_inside_a_kernel_scope_is_exempt():
    g = _record(_dequant, _ring(), torch.ones(1), kernel="fused_decode")
    (c,) = g.converts()
    assert c.in_kernel and c.kernel == "fused_decode"
    assert convert_ledger(g)["count"] == 0
    (k,) = g.kernels
    assert (k.op, k.tier) == ("fused_decode", "torch")
    assert k.args == (("int8", CACHE_DIMS), ("float32", (1,)))


def test_resolve_returns_the_impl_itself_with_no_recorder():
    x = torch.zeros((2, 4))
    impl = dispatch._REGISTRY["quantize_act"]["torch"]
    assert dispatch.resolve("quantize_act", x) is impl
    g = OpGraph("t")
    rec = GraphRecorder(g)
    with dispatch.recording(rec):
        wrapped = dispatch.resolve("quantize_act", x)
    assert wrapped is not impl and wrapped.__wrapped__ is impl
    assert dispatch.resolve("quantize_act", x) is impl   # closed again


def test_a_kernel_call_is_one_node_and_its_ops_are_scoped():
    a = torch.randn(8, 64)
    w = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
    s = torch.ones(128)
    g = record_graph("w8a16", qmatmul_w8a16, (a, w, s),
                     {"out_dtype": torch.float32})
    assert g.kernel_counts() == {"qmatmul_w8a16": 1}
    (c,) = g.converts()                   # the plain version's weight cast
    assert c.kernel == "qmatmul_w8a16" and c.shape == (64, 128)
    assert all(r.kernel == "qmatmul_w8a16" for r in g.records)


def test_records_keep_writes_allocations_and_pool_storage():
    pool = {"k": _ring(), "kpos": torch.zeros(2, 8, dtype=torch.int64)}

    def step(cache):
        cache["k"][0] = 1                       # in place
        cache["kpos"] = cache["kpos"] + 1       # rebound

    g = _record(step, pool, pool=pool)
    assert g.pool_before["k"] == g.pool_after["k"]
    assert g.pool_before["kpos"][0] != g.pool_after["kpos"][0]
    writes = [t for r in g.records for t in r.mutated]
    assert any(t.shape == CACHE_DIMS[1:] for t in writes)
    assert any(t.shape == (2, 8) for r in g.records for t in r.allocated)


# ------------------------------------------------------------- graph_diag
def test_graph_diag_ranks_collectives_by_bytes():
    g = OpGraph("t", collectives=[
        ("all-reduce", "float32", (256,), 1024),
        ("all-gather", "int8", (2, 4, 8), 64),
        ("all-reduce", "float32", (256,), 1024)])
    rows = graph_diag.top_collectives(g)
    assert rows[0] == (2048, 2, "all-reduce", "float32[256]")
    assert rows[1] == (64, 1, "all-gather", "int8[2,4,8]")
    assert graph_diag.top_collectives(g, k=1) == rows[:1]


# --------------------------------------------------------------- registry
def test_registry_rejects_duplicates_and_unknown_rules():
    with pytest.raises(ValueError, match="already registered"):
        register_rule("dtype-ledger")(lambda g, c: [])
    with pytest.raises(ValueError, match="unknown lint rule"):
        run_rules(_graph({}), rules=["no-such-rule"])
    with pytest.raises(ValueError, match="severity"):
        Finding("r", "fatal", "j", "w", "m")


# ----------------------------------------------------------- dtype-ledger
def _decode_dequant():
    return _record(_dequant, _ring(), torch.ones(CACHE_DIMS[:-1] + (1,)))


def test_dtype_ledger_passes_on_a_convert_inside_a_kernel():
    g = _graph({"decode": _artifact("decode", "decode", graph=_record(
        _dequant, _ring(), torch.ones(1), kernel="fused_decode"))})
    assert run_rules(g, rules=["dtype-ledger"]) == []


def test_dtype_ledger_flags_an_injected_decode_dequant():
    g = _graph({"decode": _artifact("decode", "decode",
                                    graph=_decode_dequant())})
    (f,) = run_rules(g, rules=["dtype-ledger"])
    assert f.severity == "error" and f.jit == "decode"
    assert "8x2x4" in f.where and "inside a kernel" in f.message
    # no debt channel on a decode path, not even the structural one
    (f,) = run_rules(g, structural_contract(), rules=["dtype-ledger"])
    assert f.severity == "error"


def test_dtype_ledger_prefill_debt_channel():
    g = _graph({"prefill": _artifact("prefill", "prefill",
                                     graph=_decode_dequant())})
    # no contract entry: the dequant is an error demanding an explicit pin
    (f,) = run_rules(g, rules=["dtype-ledger"])
    assert f.severity == "error" and "known_debt" in f.message
    # pinned: same graph, same rule, now an info
    contract = {"known_debt": [{"rule": "dtype-ledger", "jit": "prefill",
                                "shape": list(CACHE_DIMS)}]}
    (f,) = run_rules(g, contract, rules=["dtype-ledger"])
    assert f.severity == "info"
    # the structural debts cover it at any shape
    (f,) = run_rules(g, structural_contract(), rules=["dtype-ledger"])
    assert f.severity == "info"


def test_dtype_ledger_ignores_weight_shaped_dequant():
    # a [K, N] weight dequant outside a kernel counts in the ledger's
    # totals; only cache-ring shapes are errors
    g = _record(_dequant, torch.zeros((64, 128), dtype=torch.int8),
                torch.ones(128))
    art = _artifact("decode", "decode", graph=g)
    (c,) = g.converts()
    assert not is_cache_dequant(c, art)
    assert run_rules(_graph({"decode": art}), rules=["dtype-ledger"]) == []
    assert convert_ledger(g)["count"] == 1
    assert convert_ledger(g)["bytes"] == 64 * 128 * 4


def test_dtype_ledger_drift_against_contract():
    g = _graph({"decode": _artifact("decode", "decode", graph=_record(
        _dequant, torch.zeros((4, 4), dtype=torch.int8), torch.ones(4)))})
    contract = {"jits": {"decode": {"int8_converts": {"count": 0,
                                                      "bytes": 0}}}}
    findings = run_rules(g, contract, rules=["dtype-ledger"])
    assert {f.where for f in findings} == {"count", "bytes"}
    assert all("ledger drift" in f.message for f in findings)


# ------------------------------------------------------ collective-budget
def _pool_artifact(name, events):
    return _artifact(
        name, "prefill", graph=OpGraph(name, collectives=events),
        cache_leaves_global=[("int8", (2, 4, 8, 2, 4))],
        cache_leaves_local=[("int8", (2, 2, 8, 2, 4))])


_POOL_AG = [("all-gather", "int8", (2, 4, 8, 2, 4), 512)]


def test_collective_budget_flags_pool_gather_under_tp():
    g = _graph({"prefill": _pool_artifact("prefill", _POOL_AG)},
               mesh_shape=(2, 4))
    (f,) = [f for f in run_rules(g, rules=["collective-budget"])
            if f.severity == "error"]
    assert f.jit == "prefill" and f.where == "#0"
    assert "cache-pool leaf" in f.message and "int8[2,4,8,2,4]" in f.message


def test_collective_budget_known_debt_downgrades_to_info():
    g = _graph({"prefill": _pool_artifact("prefill", _POOL_AG)},
               mesh_shape=(2, 4))
    contract = {"known_debt": [{"rule": "collective-budget",
                                "jit": "prefill",
                                "type": "int8[2,4,8,2,4]"}]}
    findings = run_rules(g, contract, rules=["collective-budget"])
    assert [f.severity for f in findings] == ["info"]


def test_collective_budget_page_table_is_not_a_pool_hit():
    art = _pool_artifact("prefill", [("all-reduce", "int64", (4, 4), 128)])
    art.cache_leaves_local.append(("int64", (4, 4)))
    art.page_table_shapes = [("int64", (4, 4))]
    g = _graph({"prefill": art}, mesh_shape=(2, 4))
    assert run_rules(g, rules=["collective-budget"]) == []


def test_collective_budget_extra_collective_vs_contract():
    g = _graph({"prefill": _pool_artifact("prefill", _POOL_AG)},
               mesh_shape=(1, 1))           # not TP: only the budget applies
    contract = {"jits": {"prefill": {"collectives": {}}}}
    (f,) = run_rules(g, contract, rules=["collective-budget"])
    assert f.severity == "error" and f.where == "all-gather"
    assert "new collective traffic" in f.message


def test_collective_budget_win_still_requires_repin():
    g = _graph({"prefill": _pool_artifact("prefill", [])}, mesh_shape=(1, 1))
    contract = {"jits": {"prefill": {"collectives": {"all-gather": [1, 512]}}}}
    (f,) = run_rules(g, contract, rules=["collective-budget"])
    assert "a win" in f.message


# --------------------------------------------------------- donation-audit
def _audited(step, views=None):
    pool = {"k": _ring(), "kpos": torch.zeros(2, 8, dtype=torch.int64)}
    g = _record(step, pool, pool=pool, views=views)
    return _artifact("decode", "decode", graph=g,
                     pool_payload=[("int8", CACHE_DIMS)])


def test_donation_audit_passes_on_in_place_writes():
    def step(cache):
        cache["k"][0] = 1
        cache["kpos"].copy_(cache["kpos"] + 1)

    assert run_rules(_graph({"decode": _audited(step)}),
                     rules=["donation-audit"]) == []


def test_donation_audit_flags_a_reassigned_leaf():
    def step(cache):
        cache["kpos"] = cache["kpos"] + 1

    (f,) = run_rules(_graph({"decode": _audited(step)}),
                     rules=["donation-audit"])
    assert f.severity == "error" and f.where == "kpos"
    assert "dead buffer" in f.message


def test_donation_audit_flags_a_pool_sized_copy():
    def step(cache):
        cache["k"].clone()

    (f,) = run_rules(_graph({"decode": _audited(step)}),
                     rules=["donation-audit"])
    assert f.severity == "error" and f.where == "int8[8,2,4]"
    assert "copy of the pool" in f.message


def test_donation_audit_dense_view_debt_channel():
    view = torch.zeros(CACHE_DIMS, dtype=torch.int8)

    def step(cache):
        view.copy_(cache["k"])

    g = _graph({"decode": _audited(step, views={"k": view})})
    (f,) = run_rules(g, rules=["donation-audit"])
    assert f.severity == "error" and f.where == "dense view"
    (f,) = run_rules(g, structural_contract(), rules=["donation-audit"])
    assert f.severity == "info"


def test_donation_audit_captured_pointers_follow_the_pool():
    g = _graph({}, captured={("decode_horizon", 1)},
               captured_ptrs={("decode_horizon", 1): {"k": 4096}},
               pool_ptrs={"k": 4096})
    assert run_rules(g, rules=["donation-audit"]) == []
    g.pool_ptrs = {"k": 8192}
    (f,) = run_rules(g, rules=["donation-audit"])
    assert f.jit == "decode_horizon[1]" and f.where == "k"


def test_donation_audit_pool_layout_against_the_contract():
    g = _graph({}, pool_leaves={"k": "int8[2,4,8,2,4]"})
    assert run_rules(g, {"pool": {"k": "int8[2,4,8,2,4]"}},
                     rules=["donation-audit"]) == []
    (f,) = run_rules(g, {"pool": {"k": "int8[2,4,16,2,4]"}},
                     rules=["donation-audit"])
    assert f.where == "pool/k" and "layout changed" in f.message


# ---------------------------------------------------- recompilation-guard
def test_recompilation_guard_closure():
    shapes = {("prefill_multi", 1), ("decode_horizon", 1),
              ("decode_horizon", 2)}
    g = _graph({}, warmup_shapes=set(shapes), dispatch_shapes=set(shapes))
    assert run_rules(g, rules=["recompilation-guard"]) == []
    g.dispatch_shapes.add(("decode_horizon", 3))    # a live-capture shape
    (f,) = run_rules(g, rules=["recompilation-guard"])
    assert f.severity == "error" and f.jit == "decode_horizon"
    assert "warmup" in f.message and "3" in f.where


def test_recompilation_guard_contract_set_equality():
    shapes = {("decode_horizon", 1)}
    g = _graph({}, warmup_shapes=set(shapes), dispatch_shapes=set(shapes))
    contract = {"warmup_shapes": [["decode_horizon", 1],
                                  ["decode_horizon", 2]]}
    findings = run_rules(g, contract, rules=["recompilation-guard"])
    assert [f.severity for f in findings] == ["error", "error"]
    assert "no longer captured" in findings[0].message
    assert "no dispatch's" in findings[1].message
    # a warmed shape no dispatch uses
    g.warmup_shapes = {("decode_horizon", 1), ("decode_horizon", 2)}
    (f,) = run_rules(g, contract, rules=["recompilation-guard"])
    assert f.where == "2" and "no step replays" in f.message


def test_recompilation_guard_captured_graphs():
    shapes = {("prefill_multi", 4), ("decode_horizon", 1)}
    g = _graph({}, warmup_shapes=set(shapes), dispatch_shapes=set(shapes),
               captured={("decode_horizon", 1)})
    assert run_rules(g, rules=["recompilation-guard"]) == []   # not warmed
    g.warmed = True
    (f,) = run_rules(g, rules=["recompilation-guard"])
    assert f.jit == "prefill_multi" and "mid-traffic" in f.message
    g.captured = shapes | {("decode_horizon", 2)}
    (f,) = run_rules(g, rules=["recompilation-guard"])
    assert "not a warmup shape" in f.message


# ------------------------------------------------------- scale-coupling
def _coupling_graph(q_spec, s_spec, s_shape=(128,)):
    leaves = {
        "/blocks/attn/wq/q": {"dtype": "int8", "shape": [64, 128],
                              "spec": q_spec},
        "/blocks/attn/wq/scale": {"dtype": "float32", "shape": list(s_shape),
                                  "spec": s_spec},
    }
    return _graph({}, param_leaves=leaves,
                  scale_pairs=[("/blocks/attn/wq/q",
                                "/blocks/attn/wq/scale")],
                  mesh_shape=(2, 4))


def test_scale_coupling_passes_on_cosharded_pair():
    g = _coupling_graph([None, "model"], ["model"])
    assert run_rules(g, rules=["scale-coupling"]) == []


def test_scale_coupling_flags_decoupled_scale():
    g = _coupling_graph([None, "model"], [None])
    (f,) = run_rules(g, rules=["scale-coupling"])
    assert f.severity == "error" and "wq/scale" in f.where
    assert "'model'" in f.message


def test_scale_coupling_flags_sharded_per_tensor_scale():
    g = _coupling_graph([None, None], ["model"], s_shape=(1,))
    (f,) = run_rules(g, rules=["scale-coupling"])
    assert "per-tensor scale" in f.message


def test_scale_coupling_missing_scale_leaf():
    g = _coupling_graph([None, "model"], ["model"])
    del g.param_leaves["/blocks/attn/wq/scale"]
    (f,) = run_rules(g, rules=["scale-coupling"])
    assert "no scale leaf" in f.message


def test_scale_coupling_cache_scale_follows_payload():
    cache = {
        "/k": {"dtype": "int8", "shape": [2, 4, 8, 2, 4],
               "spec": [None, "data", None, "model", None]},
        "/k_scale": {"dtype": "float32", "shape": [2, 4, 8, 2],
                     "spec": [None, "data", None, "model"]},
    }
    g = _graph({}, cache_spec_leaves=cache, mesh_shape=(2, 4))
    assert run_rules(g, rules=["scale-coupling"]) == []
    cache["/k_scale"]["spec"] = [None, "data", None, None]   # head decouple
    (f,) = run_rules(g, rules=["scale-coupling"])
    assert f.severity == "error" and "head axis" in f.message


# ------------------------------------------------------------- contracts
def test_diff_contracts_reports_drift_and_wins():
    old = {"recipe": "r", "mesh": None, "engine": {"num_slots": 4},
           "pool": {"k": "int8[2,4,8,2,4]"},
           "warmup_shapes": [["decode_horizon", 1]],
           "jits": {"decode": {"collectives": {"all-gather": [1, 512]},
                               "int8_converts": {"count": 2, "bytes": 64}}},
           "known_debt": [{"rule": "collective-budget", "jit": "prefill"}]}
    new = {"recipe": "r", "mesh": None, "engine": {"num_slots": 4},
           "pool": {"k": "int8[2,4,16,2,4]"},
           "warmup_shapes": [["decode_horizon", 1], ["decode_horizon", 2]],
           "jits": {"decode": {"collectives": {"all-gather": [2, 1024]},
                               "int8_converts": {"count": 2, "bytes": 64}}},
           "known_debt": []}
    lines = "\n".join(diff_contracts(old, new))
    assert "warmup shape added" in lines
    assert "all-gather [1, 512] -> [2, 1024]" in lines
    assert "pool leaf k: int8[2,4,8,2,4] -> int8[2,4,16,2,4]" in lines
    assert "REMOVED (a win)" in lines
    assert diff_contracts(old, old) == []
    assert diff_contracts(None, new) and "new contract" in \
        diff_contracts(None, new)[0]


def test_known_debt_ratchet_grows_only_by_new_entries():
    d1 = {"rule": "dtype-ledger", "jit": "prefill", "shape": [4]}
    d2 = {"rule": "donation-audit", "jit": "decode", "where": "dense view"}
    assert debt_growth(None, {"known_debt": [d1]}) == []
    assert debt_growth({"known_debt": [d1]}, {"known_debt": [d1]}) == []
    assert debt_growth({"known_debt": [d1, d2]}, {"known_debt": [d1]}) == []
    assert debt_growth({"known_debt": [d1]}, {"known_debt": [d1, d2]}) == [d2]


# ------------------------------------------------ recipe helpers vs JAX
def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:   # noqa: BLE001 — the error is the outcome
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("flag", ["", "+paged", "+paged+paged", "+bogus",
                                  "+", "+paged+x"])
def test_recipe_helpers_equal_the_jax_packages(flag):
    """split_recipe_flags, lint_mesh_shape and contract_stem give the JAX
    package's outputs, or its error and message, for every built-in recipe
    (and two that are not) under every flag and mesh."""
    assert torch_recipes.list_recipes() == jax_recipes.list_recipes()
    names = jax_recipes.list_recipes() + ["serve-w8a16-tpx", "nope-tp"]
    for base, mesh in itertools.product(names, [None, (2, 4), (1, 2)]):
        name = base + flag
        for fn, args in (("split_recipe_flags", (name,)),
                         ("lint_mesh_shape", (name,)),
                         ("contract_stem", (name, mesh))):
            assert (_outcome(getattr(torch_recipes, fn), *args)
                    == _outcome(getattr(jax_recipes, fn), *args)), (fn, args)
