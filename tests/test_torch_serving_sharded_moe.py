"""Tensor-parallel serving of the MoE family (mixtral-8x22b, llama4-scout)
over a ``torch.distributed`` mesh, against the JAX single-device engine, on
the CPU over gloo.

The reference serves an MoE arch over a mesh through ``_moe_block_local``
(only the training helper arms ``_moe_block_shardmap``), GSPMD
partitioning it under the serve-mode specs, so the oracle is the one-device
result: the sharded engine gives the JAX single-device engine's tokens,
admission and finish ticks — fp32, ``serve-w8a16-tp`` and
``serve-w8a8-kv8-tp``, fast and stepwise, the contiguous and the paged
pool — at meshes 1x2, 2x1 and 2x2, for both smoke configs and a widened
smoke config (``d_model`` 256, ``head_dim`` 64, ``d_ff`` 512) at capacity
factor 1.25, where choices drop (the smoke's 4.0 drops none). One MoE
block on the same activations: the router's logits bit-equal to one
device (the router is whole on every rank; where the planner would cut
it, 128 experts, serving refuses), the drops of every row equal,
mixtral's W8A8 output bit-equal (the expert down projection's int32
partials summed, then the epilogue), the rest within the reference's
tolerance (fp32, W8A16, and llama4's W8A8, whose shared expert is a float
MLP cut over "model"); chip_smoke.py's MoE-block gate passes the block
and fails it with a planted fault (the ranks' partial sums not added).
Prefill logits: mixtral's W8A8 bit-equal to the port's one device, the
rest within atol 2e-5 / rtol 1e-5 with the same argmax. The planner's
MoE specs equal JAX's at mixtral's and llama4's full shapes; the
expert-batched int32 GEMM's plain version equals the per-expert one, and
through the epilogue the expert-batched W8A8 GEMM; ``--arch mixtral-8x22b
--mesh 1x2`` and ``--load`` of its artifact over the recorded mesh.

The rank groups are spawned once a module (``_torch_sharded.run_ranks``:
one group of 2, one of 4), every check of their meshes in that spawn.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import repro
from repro.configs import get_config
from repro.models import build_model
from repro.quantized.qtensor import QTensor as JaxQTensor
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.sharding import partition as jpart

import repro_torch
from repro_torch.kernels.qmatmul_w8a8.ops import qmatmul_w8a8, qmatmul_w8a8_i32
from repro_torch.kernels.qmatmul_w8a8.ref import (
    qmatmul_w8a8_i32_ref,
    w8a8_epilogue,
)
from repro_torch.quantized.qtensor import QTensor
from repro_torch.serving import ServingEngine
from repro_torch.sharding import partition as tpart

from _torch_port import jax_to_numpy
from _torch_sharded import run_ranks

ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
VARIANTS = ["fp32", "serve-w8a16-tp", "serve-w8a8-kv8-tp"]
#: the widened smoke config, at a capacity factor that drops choices
WIDE = dict(d_model=256, head_dim=64, d_ff=512, capacity_factor=1.25)
#: the smoke config with more experts than MIN_SHARD_DIM: the planner
#: cuts its router's columns over "model"
MANY = dict(n_experts=128)
#: 2 slots for 4 requests (slot recycling); mixtral's smoke window (16)
#: caps the ring
ENGINE = dict(num_slots=2, max_len=32, prefill_chunk=8)
LAYOUTS = {"contiguous": {}, "paged": {"page_size": 8}}
_CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
MESHES_2 = [(1, 2), (2, 1)]
MESHES_4 = [(2, 2)]


def _mixed(vocab):
    """The reference's mixed trace (a gen-at-prefill request included),
    each request within mixtral's 16-position ring."""
    rng = np.random.RandomState(7)
    lens = [(5, 6), (12, 3), (3, 1), (9, 8)]
    return [(i, rng.randint(0, vocab, size=p).astype(np.int32), g, 0.0)
            for i, (p, g) in enumerate(lens)]


def _exact(arch, variant):
    """Whether the sharded forward is one device's bit for bit: W8A8, whose
    row-parallel sums are int32, and no float weight cut over "model" —
    llama4's shared expert is a float MLP (not a weight site), its
    row-parallel down a float32 sum in another order."""
    return variant == "serve-w8a8-kv8-tp" and not arch.startswith("llama4")


def _over(which):
    return {"smoke": None, "wide": WIDE, "many": MANY}[which]


def _sides():
    """{(arch, variant, which): (JAX model, params, cfg, numpy params,
    kv_bits)}."""
    out = {}
    for arch in ARCHS:
        for which in ("smoke", "wide", "many"):
            jcfg = get_config(arch, smoke=True)
            if _over(which):
                jcfg = dataclasses.replace(jcfg, **_over(which))
            jm = build_model(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            for variant in VARIANTS:
                if which == "many" and (arch != ARCHS[0]
                                        or variant != "serve-w8a8-kv8-tp"):
                    continue
                m, p, c = jm, jp, jcfg
                if variant != "fp32":
                    qm = repro.quantize(jm, params=jp, recipe=variant)
                    m, p, c = qm.model, qm.params, qm.cfg
                out[arch, variant, which] = (m, p, c, jax_to_numpy(p),
                                             8 if "kv8" in variant else 16)
    return out


@pytest.fixture(scope="module")
def sides():
    return _sides()


_JAX_RUNS: dict = {}


def _jax_tokens(sides, arch, variant, which, fast, layout):
    key = (arch, variant, which, fast, layout)
    if key not in _JAX_RUNS:
        jm, jp, jcfg, _, kv_bits = sides[arch, variant, which]
        eng = JaxServingEngine(jm, jp, jcfg, fast=fast, kv_bits=kv_bits,
                               **ENGINE, **LAYOUTS[layout])
        out = eng.run([JaxRequest(rid=rid, prompt=p, max_new_tokens=g,
                                  arrival=a)
                       for rid, p, g, a in _mixed(jcfg.vocab_size)])
        _JAX_RUNS[key] = {rid: ([int(t) for t in r.tokens], r.admitted_at,
                                r.finished_at, r.status)
                          for rid, r in out.items()}
    return _JAX_RUNS[key]


def _arch(arch):
    return arch + "-smoke"


def _engine_task(sides, shape, arch, variant, which, fast, layout):
    _, _, jcfg, params_np, kv_bits = sides[arch, variant, which]
    name = ("engine", shape, arch, variant, which, fast, layout)
    return (name, "engine", shape, dict(
        arch=_arch(arch), params=params_np,
        requests=_mixed(jcfg.vocab_size), kv_bits=kv_bits,
        overrides=_over(which),
        engine={**ENGINE, "fast": fast, **LAYOUTS[layout]}))


def _x(jcfg, B=4, T=16, seed=5):
    return (np.random.RandomState(seed).standard_normal(
        (B, T, jcfg.d_model)) * 0.5).astype(np.float32)


def _block_task(sides, shape, arch, variant, which):
    _, _, jcfg, params_np, _ = sides[arch, variant, which]
    return (("moe_block", shape, arch, variant, which), "moe_block", shape,
            dict(arch=_arch(arch), params=params_np, x=_x(jcfg),
                 overrides=_over(which)))


def _gate_task(sides, shape, arch, variant):
    _, _, jcfg, params_np, _ = sides[arch, variant, "smoke"]
    return (("gate", shape, arch, variant), "gate", shape,
            dict(arch=_arch(arch), params=params_np, x=_x(jcfg),
                 chip_smoke=str(_CHIP_SMOKE)))


def _refuse_task(sides, shape):
    _, _, _, params_np, _ = sides[ARCHS[0], "serve-w8a8-kv8-tp", "many"]
    return (("refuse", shape), "refuse", shape,
            dict(arch=_arch(ARCHS[0]), params=params_np, overrides=MANY))


def _logits_task(sides, shape, arch, variant, which):
    _, _, jcfg, params_np, kv_bits = sides[arch, variant, which]
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size, size=(1, 8))
    return (("logits", shape, arch, variant, which), "logits", shape, dict(
        arch=_arch(arch), params=params_np, tokens=toks, kv_bits=kv_bits,
        overrides=_over(which)))


def _parity_cases(meshes):
    return ([(s, a, v, "smoke", f, lay) for s in meshes for a in ARCHS
             for v in VARIANTS for f in (True, False) for lay in LAYOUTS]
            + [(s, a, v, "wide", f, "contiguous") for s in meshes
               for a in ARCHS for v in VARIANTS for f in (True, False)]
            + [(s, a, "serve-w8a8-kv8-tp", "wide", True, "paged")
               for s in meshes for a in ARCHS])


CASES_2 = _parity_cases(MESHES_2)
CASES_4 = _parity_cases(MESHES_4)
BLOCKS = [(a, v, w) for a in ARCHS for v in VARIANTS
          for w in ("smoke", "wide")]


def _counts_task(sides, shape, arch, variant, which):
    _, _, jcfg, params_np, kv_bits = sides[arch, variant, which]
    return (("counts", shape, arch, variant, which), "counts", shape, dict(
        arch=_arch(arch), params=params_np,
        requests=_mixed(jcfg.vocab_size), kv_bits=kv_bits,
        overrides=_over(which), engine={**ENGINE, "fast": True}))


#: the runs whose kernel calls are held to chip_smoke's phase-14 count
COUNTED = [(a, v, w) for a in ARCHS for v in VARIANTS[1:]
           for w in ("smoke", "wide")]


def _other_tasks(sides, meshes):
    tasks = [_counts_task(sides, s, *c) for s in meshes for c in COUNTED]
    tasks += [_block_task(sides, s, *b) for s in meshes for b in BLOCKS]
    tasks += [_gate_task(sides, s, a, v) for s in meshes if s[1] > 1
              for a in ARCHS for v in VARIANTS]
    tasks += [_refuse_task(sides, s) for s in meshes if s[1] > 1]
    tasks += [_logits_task(sides, s, a, v, w) for s in meshes for a in ARCHS
              for v in ("fp32", "serve-w8a8-kv8-tp")
              for w in ("smoke", "wide")]
    return tasks


#: mixtral's widened smoke config at ONE layer in bf16 (the serving dtype),
#: W8A16 over 1x2 teacher-forced: the depth at which chip_smoke's 14a read
#: its sharded logits 0.159 of max |logit| off one device's on the card
ONE_LAYER = dict(WIDE, n_layers=1, dtype="bfloat16")


def _one_layer_side():
    """(JAX quantized model in bf16 and in float32, its params, numpy
    params, tokens [16, 16])."""
    jcfg = dataclasses.replace(get_config(ARCHS[0], smoke=True), **ONE_LAYER)
    jm = build_model(jcfg)
    qm = repro.quantize(jm, params=jm.init(jax.random.PRNGKey(0)),
                        recipe="serve-w8a16-tp")
    jm32 = build_model(dataclasses.replace(qm.model.cfg, dtype="float32"))
    toks = np.random.RandomState(11).randint(0, jcfg.vocab_size,
                                             size=(16, 16))
    return qm.model, jm32, qm.params, jax_to_numpy(qm.params), toks


@pytest.fixture(scope="module")
def one_layer():
    return _one_layer_side()


@pytest.fixture(scope="module")
def world2(sides, one_layer, tmp_path_factory):
    tasks = [_engine_task(sides, *c) for c in CASES_2]
    teacher = (("teacher", (1, 2)), "teacher", (1, 2), dict(
        arch=_arch(ARCHS[0]), params=one_layer[3], tokens=one_layer[4],
        kv_bits=16, chip_smoke=str(_CHIP_SMOKE), overrides=ONE_LAYER))
    return run_ranks(2, tasks + _other_tasks(sides, MESHES_2) + [teacher],
                     tmp_path_factory.mktemp("moe2"))


@pytest.fixture(scope="module")
def world4(sides, tmp_path_factory):
    tasks = [_engine_task(sides, *c) for c in CASES_4]
    return run_ranks(4, tasks + _other_tasks(sides, MESHES_4),
                     tmp_path_factory.mktemp("moe4"))


def _world(shape, world2, world4):
    return world2 if shape in MESHES_2 else world4


def _case_id(c):
    shape, arch, variant, which, fast, layout = c
    return (f"{'x'.join(map(str, shape))}-{arch.split('-')[0]}-{variant}-"
            f"{which}-{'fast' if fast else 'stepwise'}-{layout}")


def _check_parity(got, sides, case):
    shape, arch, variant, which, fast, layout = case
    want = _jax_tokens(sides, arch, variant, which, fast, layout)
    assert got["results"] == want, f"{_case_id(case)}: diverged from JAX"
    for rid, _, g, _ in _mixed(sides[arch, variant, which][2].vocab_size):
        assert got["results"][rid][3] == "ok"
        assert len(got["results"][rid][0]) == g


# ----------------------------------------------------- sharded-vs-single

@pytest.mark.parametrize("case", CASES_2, ids=_case_id)
def test_moe_sharded_engine_matches_jax_single_device_2_ranks(case, sides,
                                                              world2):
    """1x2 and 2x1: tokens, admission and finish ticks and statuses equal
    the JAX single-device engine's."""
    _check_parity(world2[("engine",) + case], sides, case)


@pytest.mark.parametrize("case", CASES_4, ids=_case_id)
def test_moe_sharded_engine_matches_jax_single_device_4_ranks(case, sides,
                                                              world4):
    """2x2: the same."""
    _check_parity(world4[("engine",) + case], sides, case)


def test_moe_placement_cuts_the_experts_and_keeps_the_router_whole(world2,
                                                                   world4):
    """At 1x2 and 2x2 each rank holds its F columns of the experts' gate /
    up and its F rows of their down (llama4's shared expert alike), the
    router whole; the flags say so."""
    for world, shape in ((world2, (1, 2)), (world4, (2, 2))):
        for arch in ARCHS:
            got = world[("engine", shape, arch, "serve-w8a8-kv8-tp", "smoke",
                         True, "contiguous")]
            shapes = got["param_shapes"]
            assert shapes["/blocks/mlp/experts/wg/q"] == (2, 4, 64, 64)
            assert shapes["/blocks/mlp/experts/wd/q"] == (2, 4, 64, 64)
            assert shapes["/blocks/mlp/router/q"] == (2, 64, 4)
            assert got["col"]["experts/wg"] and got["col"]["experts/wu"]
            assert got["row"]["experts/wd"]
            if arch.startswith("llama4"):
                assert shapes["/blocks/mlp/shared/wu"] == (2, 64, 64)
                assert shapes["/blocks/mlp/shared/wd"] == (2, 64, 64)
                assert shapes["/blocks/mlp/shared/bd"] == (2, 64)
                assert got["col"]["shared/wu"] and got["row"]["shared/wd"]
            else:
                assert "shared/wu" not in got["col"]
    got = world2[("engine", (2, 1), ARCHS[0], "fp32", "smoke", True,
                  "contiguous")]
    assert got["slots_sharded"] and got["cache_shapes"]["kpos"] == (1, 16)


# ------------------------------------------------------- one MoE block

def _block(shape, case, world2, world4):
    return _world(shape, world2, world4)[("moe_block", shape) + case]


@pytest.mark.parametrize("shape", MESHES_2 + MESHES_4,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", BLOCKS, ids=lambda c: "-".join(
    (c[0].split("-")[0],) + c[1:]))
def test_router_logits_bit_equal_and_drops_equal(shape, case, world2,
                                                 world4):
    """The router's logits on the same activations are one device's bit for
    bit, and so are the choices each row dropped; the block's output is
    bit-equal under W8A8 and within the pinned tolerance otherwise (a
    reordered float32 sum over the ranks' F blocks)."""
    r = _block(shape, case, world2, world4)
    one, got = r["single"], r["sharded"]
    assert np.array_equal(got["logits"], one["logits"])
    assert np.array_equal(got["drops"], one["drops"])
    if not r["slots_sharded"]:
        assert got["aux"] == one["aux"]
    if _exact(case[0], case[1]):
        assert np.array_equal(got["y"], one["y"])
    else:
        np.testing.assert_allclose(got["y"], one["y"], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_moe_block_gate_fails_a_dropped_partial(arch, variant, shape,
                                                 world2, world4):
    """chip_smoke.py's phase-14 MoE-block gate (``moe_block_gap`` within
    ``MOE_BLOCK_TOL``, W8A8 mixtral at 0): the sharded block passes it —
    router logits bit-equal, drops equal — and with a planted fault, each
    rank keeping its own partial sums over "model" instead of adding them,
    the block is far outside it (routing unmoved: the gate reads the
    block's arithmetic alone)."""
    r = _world(shape, world2, world4)[("gate", shape, arch, variant)]
    same_logits, same_drops, gap = r["honest"]
    assert same_logits and same_drops
    assert gap <= (0.0 if _exact(arch, variant) else r["tol"])
    same_logits, same_drops, gap = r["faulty"]
    assert same_logits and same_drops
    assert gap > 10 * r["tol"], gap


def test_capacity_drops_choices_in_the_wide_config(world2):
    """The widened config's capacity factor 1.25 drops choices (the drop
    path runs), the smoke config's 4.0 none."""
    for arch in ARCHS:
        wide = world2[("moe_block", (1, 2), arch, "fp32", "wide")]
        smoke = world2[("moe_block", (1, 2), arch, "fp32", "smoke")]
        assert wide["single"]["drops"].sum() > 0
        assert smoke["single"]["drops"].sum() == 0


def test_router_whole_where_the_planner_cuts_it(world2, world4):
    """128 experts: the planner records the router column-parallel over
    "model" (what an artifact says); serving holds the router whole on
    every rank, so the shard refuses that cut, naming the case (no arch
    of the catalog has so many experts)."""
    for world, shape in ((world2, (1, 2)), (world4, (2, 2))):
        r = world[("refuse", shape)]
        assert "'model'" in r["router_spec"]
        assert r["refused"] is not None
        assert "128 experts" in r["refused"] and "router" in r["refused"]


@pytest.mark.parametrize("shape", MESHES_2 + MESHES_4,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("which", ["smoke", "wide"])
@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_moe_prefill_logits(shape, which, arch, world2, world4):
    """Prefill logits: mixtral's W8A8 bit-equal to the port's one device;
    fp32 and llama4's W8A8 (its float shared expert) within the
    reference's TP tolerance, the argmax unmoved."""
    world = _world(shape, world2, world4)
    for variant in ("serve-w8a8-kv8-tp", "fp32"):
        r = world[("logits", shape, arch, variant, which)]
        if _exact(arch, variant):
            assert np.array_equal(r["sharded"], r["single"])
            continue
        np.testing.assert_allclose(r["sharded"], r["single"], atol=2e-5,
                                   rtol=1e-5)
        assert np.array_equal(np.argmax(r["sharded"], -1),
                              np.argmax(r["single"], -1))


def test_wide_engine_drops_as_one_device(sides, world2):
    """The widened config's engines run the drop path: the port's one
    device drops choices on the mixed trace (its own drop log), and the
    sharded engines give the JAX engine's tokens all the same (the parity
    cases above)."""
    from repro_torch.models import build_model as torch_build_model
    from repro_torch.serving import Request
    from repro_torch.weights import from_jax_numpy

    _, _, jcfg, params_np, _ = sides[ARCHS[0], "fp32", "wide"]
    cfg = dataclasses.replace(repro_torch.get_config(_arch(ARCHS[0])), **WIDE)
    model = torch_build_model(cfg)
    model.drop_log = []
    eng = ServingEngine(model, from_jax_numpy(params_np, cfg, device="cpu"),
                        cfg, device="cpu", **ENGINE)
    out = eng.run([Request(rid=rid, prompt=p, max_new_tokens=g, arrival=a)
                   for rid, p, g, a in _mixed(cfg.vocab_size)])
    assert sum(int(d.sum()) for d in model.drop_log) > 0
    want = _jax_tokens(sides, ARCHS[0], "fp32", "wide", True, "contiguous")
    assert {rid: list(r.tokens) for rid, r in out.items()} == \
        {rid: v[0] for rid, v in want.items()}
    got = world2[("engine", (1, 2), ARCHS[0], "fp32", "wide", True,
                  "contiguous")]
    assert got["results"] == want


def _chip_smoke():
    """chip_smoke.py, loaded from the repo root (it imports torch only
    inside its functions)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", _CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", MESHES_2 + MESHES_4,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", COUNTED, ids=lambda c: "-".join(
    (c[0].split("-")[0],) + c[1:]))
def test_phase_14_launch_counts_follow_the_shard(shape, case, world2,
                                                 world4):
    """chip_smoke.py's ``moe_tp_expected_launches`` — what phase 14 holds
    each rank's launches to on the card — equals the kernel calls a
    sharded MoE engine makes here (the plain versions, counted by the
    names the CUDA wrappers count launches by), from the shard's flags and
    the run's decode steps and prefill dispatches."""
    arch, variant, which = case
    r = _world(shape, world2, world4)[("counts", shape) + case]
    cfg = repro_torch.get_config(_arch(arch))
    if _over(which):
        cfg = dataclasses.replace(cfg, **_over(which))
    quantize = "w8a8" if "w8a8" in variant else "w8a16"
    want = _chip_smoke().moe_tp_expected_launches(
        quantize, cfg, shape, r["flags"], r["stats"]["decode_steps"],
        r["stats"]["prefill_dispatches"], slots=ENGINE["num_slots"],
        chunk=ENGINE["prefill_chunk"], kv_bits=8 if "kv8" in variant else 16)
    assert {k: v for k, v in r["counts"].items() if v} == \
        {k: v for k, v in want.items() if v}


# ------------------------------------------------------------- the planner

class _StubMesh:
    """Just enough mesh for either planner: the axis sizes."""

    def __init__(self, **axes):
        self.shape = dict(axes)

    def __repr__(self):
        return "x".join(str(n) for n in self.shape.values())


PLAN_MESHES = [_StubMesh(data=1, model=2), _StubMesh(data=2, model=4),
               _StubMesh(pod=2, data=2, model=2)]


def _pack_like(full, small):
    """A full-width shape tree packed as the smoke artifact ``small`` is."""
    if isinstance(small, JaxQTensor):
        q = jax.ShapeDtypeStruct(full.shape, np.int8)
        n = 1 if small.scale.shape[-1] == 1 else full.shape[-1]
        scale = jax.ShapeDtypeStruct(full.shape[:-2] + (n,), np.float32)
        return JaxQTensor(q, scale, small.mode)
    if isinstance(small, dict):
        return {k: _pack_like(full[k], v) for k, v in small.items()}
    return full


def _meta(tree):
    if isinstance(tree, JaxQTensor):
        return QTensor(torch.empty(tree.q.shape, dtype=torch.int8,
                                   device="meta"),
                       torch.empty(tree.scale.shape, device="meta"),
                       tree.mode)
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


_FULL: dict = {}


def _full_params(arch, recipe):
    key = (arch, recipe)
    if key not in _FULL:
        jm = build_model(get_config(arch))
        p = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        if recipe != "fp32":
            small = repro.quantize(arch + "-smoke", recipe=recipe).params
            p = _pack_like(p, small)
        _FULL[key] = p
    return _FULL[key]


@pytest.mark.parametrize("mesh", PLAN_MESHES, ids=repr)
@pytest.mark.parametrize("recipe", ["fp32", "serve-w8a16-tp",
                                    "serve-w8a8-kv8-tp"])
@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_moe_serve_specs_equal_jax_at_full_shapes(arch, recipe, mesh):
    """The planner's serve-mode specs of mixtral's and llama4's full-width
    params (meta tensors), MoE leaves included, print as JAX's leaf for
    leaf."""
    cfg = get_config(arch)
    heads = {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads}
    jp = _full_params(arch, recipe)
    want = {p: str(s) for p, s in jpart.spec_paths(
        jpart.params_pspecs(jp, mesh, heads, mode="serve"))}
    got = {p: str(s) for p, s in tpart.spec_paths(
        tpart.params_pspecs(_meta(jp), mesh, heads, mode="serve"))}
    assert got == want
    assert any("/experts/" in p for p in got)


# -------------------------------------------- the expert-batched int32 GEMM

@pytest.mark.parametrize("E,M,K,N", [(4, 8, 64, 32), (8, 5, 33, 17),
                                     (3, 40, 128, 96)])
def test_expert_int32_gemm_plain_version(E, M, K, N):
    """The epilogue-free W8A8 GEMM with an expert axis: each expert's
    accumulator is ``qmatmul_w8a8_i32_ref``'s, and the scale epilogue
    (per-expert scales [E, M], [E, N] or [E, 1], bias [E, N]) gives the
    expert-batched ``qmatmul_w8a8``'s bits."""
    g = torch.Generator().manual_seed(E * M + K)
    a = torch.randint(-128, 128, (E, M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (E, N, K), generator=g,
                      dtype=torch.int8).transpose(1, 2)
    acc = qmatmul_w8a8_i32(a, w)
    assert acc.dtype == torch.int32 and acc.shape == (E, M, N)
    for e in range(E):
        assert torch.equal(acc[e], qmatmul_w8a8_i32_ref(a[e], w[e]))
    sa = torch.rand((E, M), generator=g) * 0.05 + 1e-4
    bias = torch.randn((E, N), generator=g)
    for sw in (torch.rand((E, N), generator=g) * 0.01 + 1e-4,
               torch.rand((E, 1), generator=g) * 0.01 + 1e-4):
        for out in (torch.float32, torch.bfloat16):
            for b in (bias, None):
                assert torch.equal(
                    w8a8_epilogue(acc, sa, sw, b, out),
                    qmatmul_w8a8(a, w, sa, sw, b, out_dtype=out)), (
                    sw.shape, out, b is None)


def test_launcher_serves_mixtral_over_a_mesh_and_its_artifact(tmp_path):
    """``--arch mixtral-8x22b --mesh 1x2`` takes the ``-tp`` recipe and
    spawns its ranks; the port's MoE ``-tp`` artifact saved with the mesh
    serves over its recorded mesh by ``--load``: the same tokens, each
    rank's launches reported."""
    out = str(tmp_path / "mixtral_tp")
    serve = dict(device="cpu", trace=4, prompt_len=8, gen_len=6,
                 prefill_chunk=4)
    first = repro_torch.serve(repro_torch.ServeConfig(
        arch="mixtral-8x22b", smoke=True, mesh=(1, 2), quantize="w8a8",
        kv_bits=8, save=out, **serve))
    assert first.mesh == (1, 2) and len(first.rank_launches) == 2
    loaded = repro_torch.QuantizedModel.load(out, device="cpu")
    assert loaded.recipe.name == "serve-w8a8-kv8-tp"
    assert loaded.sharding["mesh_shape"] == [1, 2]
    again = repro_torch.serve(repro_torch.ServeConfig(load=out, **serve))
    assert again.mesh == (1, 2)
    assert {rid: list(r.tokens) for rid, r in again.results.items()} == \
        {rid: list(r.tokens) for rid, r in first.results.items()}


def test_one_layer_w8a16_1x2_is_one_device_up_to_rounding(one_layer,
                                                          world2):
    """mixtral (widened smoke, 1 layer) W8A16 over 1x2, teacher-forced over
    16 sequences of 16, through chip_smoke's own gate (``tp_teacher_forced``
    and ``tp_teacher_gate``, as 13 and 14a run them on the card). In
    float32 the sharded logits are one device's up to rounding (the
    partials summed in another order), every MoE choice one device's, and
    the gate's bound, ``TP_F32_TOL``, sits far below a planted fault (the
    last rank's expert-down partial dropped). In bf16 no choice moves
    here, and the sharded logits stay within twice the bf16 forward's own
    distance from float32, read where that forward's choices are the
    float32 one's (a choice that moves makes a step in the function, not
    rounding: one sequence's moves read 0.31 of max |logit|). The port's
    one device holds to the JAX package's in float32 within the same
    bound, and in bf16 within the bf16 bar, its argmax moving only at
    near-ties."""
    jm, jm32, jp, _, toks = one_layer
    r = world2[("teacher", (1, 2))]
    tf, tol = r["tf"], r["tol"]
    print(r["line"])                     # the gate's readings (pytest -s)
    assert not r["fails"], r["fails"]
    assert all(t["routes_f32"] and t["routes_bf16"] for t in tf), r["line"]
    assert max(t["f32"] for t in tf) <= tol / 10, r["line"]
    assert tf[0]["planted"] > 100 * tol, r["line"]
    clean = [t for t in tf if t["routes_rounding"]]
    assert len(clean) >= len(tf) - 2, r["line"]
    bar = max(t["rounding"] for t in clean)
    assert max(t["bf16"] for t in tf) <= 2 * bar, r["line"]

    ids = jax.numpy.asarray(toks, jax.numpy.int32)
    for m, mine, limit in ((jm32, r["f32"], tol), (jm, r["single"], 2 * bar)):
        out = m.apply(jp, ids)
        theirs = np.asarray(out[0] if isinstance(out, tuple) else out,
                            np.float32)
        diff = np.abs(theirs - mine).max()
        assert diff / np.abs(mine).max() <= limit, (diff, limit)
        top2 = np.sort(mine, -1)[..., -2:]
        moved = mine.argmax(-1) != theirs.argmax(-1)
        assert np.all((top2[..., 1] - top2[..., 0])[moved] <= 2 * diff)
