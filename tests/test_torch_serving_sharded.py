"""Tensor-parallel serving of the port (``ServingEngine(mesh=...)`` over a
``torch.distributed`` mesh) against the JAX single-device engine, on the
CPU over gloo.

The reference's acceptance anchor (``tests/test_serving_sharded.py``): the
sharded engine gives the SAME tokens as the single-device engine — fp32,
``serve-w8a16-tp`` and ``serve-w8a8-kv8-tp``, fast and stepwise, from the
contiguous and the paged pool — here at meshes 1x2, 2x1 and 2x2 (and the
pod mesh 2x1x2) against the JAX package's engine on the same weights,
through slot recycling and the gen-at-prefill edge. The qwen2 smoke config
replicates every attention weight (``MIN_SHARD_DIM`` 128), so a widened
smoke config (``d_model`` 256, ``head_dim`` 64, ``d_ff`` 512), built the
same way on both sides, makes the attention projections column- and
row-parallel too. Prefill logits: fp32 within the reference's pinned
tolerance with the same argmax, W8A8 bit-equal to the port's single-device
ones (the int32 partial sums of the row-parallel GEMMs). The head-local
decode engages at 2x2 and stays off at model = 4 (2 KV heads); a slot
count that does not divide the data axis replicates. Artifacts: a ``-tp``
artifact saved with its mesh serves from ``--load`` over the recorded
mesh, port → port and JAX → port; ``serve(ServeConfig(mesh=(1, 2)))``
takes the ``-tp`` recipe and starts its ranks itself.

Each group of ranks is spawned once a module (``_torch_sharded.run_ranks``:
one process group of 2, one of 4), every check of its meshes in that one
spawn.
"""
import dataclasses

import numpy as np
import pytest

import jax
import repro
from repro.configs import get_config
from repro.models import build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

import repro_torch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve_config import ServeConfigError
from repro_torch.serving import ServingEngine

from _torch_port import jax_to_numpy
from _torch_sharded import run_ranks

ARCH = "qwen2-0.5b-smoke"
VARIANTS = ["fp32", "serve-w8a16-tp", "serve-w8a8-kv8-tp"]
#: the widened smoke config: every attention projection >= MIN_SHARD_DIM
WIDE = dict(d_model=256, head_dim=64, d_ff=512)
#: the reference's engine: 2 slots for 4 requests (slot recycling)
ENGINE = dict(num_slots=2, max_len=32, prefill_chunk=8)
LAYOUTS = {"contiguous": {}, "paged": {"page_size": 8}}
MESHES_2 = [(1, 2), (2, 1)]
MESHES_4 = [(2, 2)]
POD = (2, 1, 2)
GUARD = (1, 4)


def _mixed(vocab):
    """The reference's mixed trace (a gen-at-prefill request included)."""
    rng = np.random.RandomState(7)
    lens = [(5, 6), (12, 3), (3, 1), (9, 8)]
    return [(i, rng.randint(0, vocab, size=p).astype(np.int32), g, 0.0)
            for i, (p, g) in enumerate(lens)]


def _sides():
    """{(variant, wide): (JAX model, params, cfg, numpy params, kv_bits)}."""
    out = {}
    for wide in (False, True):
        jcfg = get_config("qwen2-0.5b", smoke=True)
        if wide:
            jcfg = dataclasses.replace(jcfg, **WIDE)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        for variant in VARIANTS:
            m, p, c = jm, jp, jcfg
            if variant != "fp32":
                qm = repro.quantize(jm, params=jp, recipe=variant)
                m, p, c = qm.model, qm.params, qm.cfg
            out[variant, wide] = (m, p, c, jax_to_numpy(p),
                                  8 if "kv8" in variant else 16)
    return out


@pytest.fixture(scope="module")
def sides():
    return _sides()


_JAX_RUNS: dict = {}


def _jax_tokens(sides, variant, wide, fast, layout, num_slots=2):
    key = (variant, wide, fast, layout, num_slots)
    if key not in _JAX_RUNS:
        jm, jp, jcfg, _, kv_bits = sides[variant, wide]
        eng = JaxServingEngine(jm, jp, jcfg, fast=fast, kv_bits=kv_bits,
                               **{**ENGINE, "num_slots": num_slots},
                               **LAYOUTS[layout])
        out = eng.run([JaxRequest(rid=rid, prompt=p, max_new_tokens=g,
                                  arrival=a)
                       for rid, p, g, a in _mixed(jcfg.vocab_size)])
        _JAX_RUNS[key] = {rid: ([int(t) for t in r.tokens], r.admitted_at,
                                r.finished_at, r.status)
                          for rid, r in out.items()}
    return _JAX_RUNS[key]


def _engine_task(sides, shape, variant, wide, fast, layout, num_slots=2):
    _, _, jcfg, params_np, kv_bits = sides[variant, wide]
    name = ("engine", shape, variant, wide, fast, layout, num_slots)
    return (name, "engine", shape, dict(
        arch=ARCH, params=params_np, requests=_mixed(jcfg.vocab_size),
        kv_bits=kv_bits, overrides=WIDE if wide else None,
        engine={**ENGINE, "num_slots": num_slots, "fast": fast,
                **LAYOUTS[layout]}))


def _logits_task(sides, shape, variant, wide):
    _, _, jcfg, params_np, kv_bits = sides[variant, wide]
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size, size=(1, 8))
    return (("logits", shape, variant, wide), "logits", shape, dict(
        arch=ARCH, params=params_np, tokens=toks, kv_bits=kv_bits,
        overrides=WIDE if wide else None))


def _parity_cases(meshes):
    return ([(s, v, False, f, lay) for s in meshes for v in VARIANTS
             for f in (True, False) for lay in LAYOUTS]
            + [(s, v, True, f, "contiguous") for s in meshes for v in VARIANTS
               for f in (True, False)]
            + [(s, "serve-w8a8-kv8-tp", True, True, "paged") for s in meshes])


CASES_2 = _parity_cases(MESHES_2)
CASES_4 = (_parity_cases(MESHES_4)
           + [(POD, v, False, True, "contiguous") for v in VARIANTS]
           + [(GUARD, v, w, True, "contiguous") for v in VARIANTS
              for w in (False, True)])


@pytest.fixture(scope="module")
def world2(sides, tmp_path_factory):
    tasks = [_engine_task(sides, *c) for c in CASES_2]
    tasks += [_logits_task(sides, s, v, w) for s in MESHES_2
              for v in ("fp32", "serve-w8a8-kv8-tp") for w in (False, True)]
    tasks.append(_engine_task(sides, (2, 1), "fp32", False, True,
                              "contiguous", num_slots=3))
    return run_ranks(2, tasks, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(sides, tmp_path_factory):
    tasks = [_engine_task(sides, *c) for c in CASES_4]
    tasks += [_logits_task(sides, s, v, w) for s in MESHES_4 + [GUARD]
              for v in ("fp32", "serve-w8a8-kv8-tp") for w in (False, True)]
    tasks.append(_engine_task(sides, (2, 2), "serve-w8a8-kv8-tp", False, True,
                              "contiguous", num_slots=4))
    tasks.append(_engine_task(sides, (2, 2), "fp32", False, True,
                              "contiguous", num_slots=3))
    return run_ranks(4, tasks, tmp_path_factory.mktemp("world4"))


def _case_id(c):
    shape, variant, wide, fast, layout = c
    return (f"{'x'.join(map(str, shape))}-{variant}{'-wide' if wide else ''}"
            f"-{'fast' if fast else 'stepwise'}-{layout}")


def _check_parity(got, sides, case):
    shape, variant, wide, fast, layout = case
    want = _jax_tokens(sides, variant, wide, fast, layout)
    assert got["results"] == want, f"{_case_id(case)}: diverged from JAX"
    for rid, prompt, g, _ in _mixed(sides[variant, wide][2].vocab_size):
        assert len(got["results"][rid][0]) == g


# ----------------------------------------------------- sharded-vs-single

@pytest.mark.parametrize("case", CASES_2, ids=_case_id)
def test_sharded_engine_matches_jax_single_device_2_ranks(case, sides,
                                                          world2):
    """1x2 and 2x1: tokens, admission and finish ticks and statuses equal
    the JAX single-device engine's."""
    _check_parity(world2[("engine",) + case + (2,)], sides, case)


@pytest.mark.parametrize("case", CASES_4, ids=_case_id)
def test_sharded_engine_matches_jax_single_device_4_ranks(case, sides,
                                                          world4):
    """2x2, the pod mesh 2x1x2 and 1x4: the same."""
    _check_parity(world4[("engine",) + case + (2,)], sides, case)


def _logits(world, shape, variant, wide):
    return world[("logits", shape, variant, wide)]


@pytest.mark.parametrize("shape", MESHES_2 + MESHES_4 + [GUARD],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "wide"])
def test_tp_logits_within_pinned_tolerance(shape, wide, world2, world4):
    """fp32: the row-parallel sums reorder float reductions — the
    reference's pinned tolerance, and the greedy argmax does not move."""
    world = world2 if shape in MESHES_2 else world4
    r = _logits(world, shape, "fp32", wide)
    np.testing.assert_allclose(r["sharded"], r["single"], atol=2e-5,
                               rtol=1e-5)
    assert np.array_equal(np.argmax(r["sharded"], -1),
                          np.argmax(r["single"], -1))


@pytest.mark.parametrize("shape", MESHES_2 + MESHES_4 + [GUARD],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "wide"])
def test_w8a8_sharded_logits_bit_equal(shape, wide, world2, world4):
    """serve-w8a8-kv8-tp: the row-parallel GEMMs sum int32 partials and
    then apply the scale epilogue, so the sharded logits are the
    single-device ones, bit for bit."""
    world = world2 if shape in MESHES_2 else world4
    r = _logits(world, shape, "serve-w8a8-kv8-tp", wide)
    assert np.array_equal(r["sharded"], r["single"])


# ------------------------------------------------------ placement contracts

def test_sharded_non_divisible_slots_replicate_and_match(sides, world2,
                                                         world4):
    """3 slots over a data axis of 2: the pool replicates (every rank holds
    all 3 slots) and the tokens equal the single-device engine's."""
    want = _jax_tokens(sides, "fp32", False, True, "contiguous", num_slots=3)
    for world, shape in ((world2, (2, 1)), (world4, (2, 2))):
        got = world[("engine", shape, "fp32", False, True, "contiguous", 3)]
        assert not got["slots_sharded"]
        assert got["cache_shapes"]["k"][1] == 3
        assert got["cache_shapes"]["kpos"] == (3, 32)
        assert got["results"] == want


def test_sharded_pool_and_param_placement(world4):
    """2x2 over 4 slots, serve-w8a8-kv8-tp: each rank holds 2 slots and 1
    of the 2 KV heads (scales with their payload), its columns of the
    column-parallel weights, its rows of the row-parallel ones, and its
    half of the vocab-parallel embedding."""
    got = world4[("engine", (2, 2), "serve-w8a8-kv8-tp", False, True,
                  "contiguous", 4)]
    cache = got["cache_shapes"]
    assert cache["k"] == (2, 2, 32, 1, 16)
    for leaf in ("k_scale", "v_scale"):
        assert cache[leaf] == (2, 2, 32, 1)
    assert cache["kpos"] == (2, 32) and cache["pos"] == (2,)
    shapes = got["param_shapes"]
    assert shapes["/blocks/mlp/wu/q"] == (2, 64, 64)      # column-parallel
    assert shapes["/blocks/mlp/wd/q"] == (2, 64, 64)      # row-parallel
    assert shapes["/blocks/attn/wq/q"] == (2, 64, 64)     # replicated (< 128)
    assert shapes["/embed"] == (128, 64)                  # vocab-parallel
    assert got["col"]["wu"] and got["row"]["wd"]
    assert not got["col"]["wq"] and not got["row"]["wo"]
    assert got["embed_sharded"] and got["slots_sharded"]


def test_head_local_decode_engages_and_matches(world4):
    """On a mesh whose model axis divides both head counts (2x2: Hq 4, Hkv
    2) the int8-KV decode runs head-local — each rank's fused decode sees
    its 2 q heads — and the tokens are the single-device engine's (the
    parity cases above)."""
    got = world4[("engine", (2, 2), "serve-w8a8-kv8-tp", False, True,
                  "contiguous", 2)]
    assert got["head_local"]
    assert got["fused_heads"] == [2]
    wide = world4[("engine", (2, 2), "serve-w8a8-kv8-tp", True, True,
                   "contiguous", 2)]
    assert wide["head_local"] and wide["fused_heads"] == [2]
    assert all(wide["col"][n] for n in ("wq", "wk", "wv", "wu"))
    assert all(wide["row"].values())


def test_head_local_guard_disengages_on_indivisible_heads(world4):
    """model = 4 does not divide the 2 KV heads: the decode attends over
    every head on every rank (the reference's guard), and with the widened
    config wq is still column-parallel (4 q heads) while wk / wv
    replicate."""
    got = world4[("engine", GUARD, "serve-w8a8-kv8-tp", False, True,
                  "contiguous", 2)]
    assert not got["head_local"] and got["fused_heads"] == [4]
    assert got["cache_shapes"]["k"][3] == 2
    wide = world4[("engine", GUARD, "serve-w8a8-kv8-tp", True, True,
                   "contiguous", 2)]
    assert not wide["head_local"] and wide["fused_heads"] == [4]
    assert wide["col"]["wq"] and not wide["col"]["wk"]
    assert wide["row"]["wo"]


# ---------------------------------------------------------------- refusals

def test_mesh_shape_and_nccl_are_checked_before_any_rank_starts():
    for bad in ((8,), (2, 0), (1, 2, 3, 4)):
        with pytest.raises(ValueError, match="positive ints"):
            make_production_mesh(shape=bad, device="cpu")
    with pytest.raises(ValueError, match="NCCL backend runs on the card"):
        make_production_mesh(shape=(1, 1), device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_production_mesh(shape=(1, 2), device="cpu")
    import torch

    if torch.cuda.device_count() < 2:
        # NCCL, the card's default, wants a card a rank: no quiet fallback
        with pytest.raises(ServeConfigError, match="one card each under "
                                                   "NCCL"):
            repro_torch.ServeConfig(mesh=(1, 2)).validate()
    repro_torch.ServeConfig(mesh=(1, 2), mesh_backend="gloo").validate()


# ------------------------------------------------------- artifact round trip

class _StubMesh:
    """A JAX-side mesh for ``QuantizedModel.save(mesh=)``: its shape and
    axis names (the planner reads nothing else)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _launcher_tokens(run):
    return {rid: list(r.tokens) for rid, r in run.results.items()}


def _single_device_tokens(directory, config):
    """The port's single-device engine over the artifact, on the
    launcher's requests."""
    from repro_torch.launch.serve import _requests
    from repro_torch.serving import required_cache_len

    qm = repro_torch.QuantizedModel.load(directory, device="cpu")
    reqs = _requests(config, qm.cfg.vocab_size)
    need = max(required_cache_len(len(r.prompt), r.max_new_tokens,
                                  config.prefill_chunk) for r in reqs)
    eng = ServingEngine.from_quantized(
        qm, num_slots=config.slots, max_len=need,
        prefill_chunk=config.prefill_chunk, device="cpu")
    return {rid: list(r.tokens) for rid, r in eng.run(reqs).items()}


SERVE = dict(device="cpu", trace=6, prompt_len=12, gen_len=6)


def test_launcher_mesh_takes_the_tp_recipe_and_round_trips(tmp_path):
    """``serve(ServeConfig(mesh=(1, 2), smoke=True))`` spawns its 2 ranks,
    quantizes the -tp twin, saves the mesh and the specs with ``--save``;
    ``--load`` of that artifact serves over the recorded mesh, the same
    tokens as the first run and as the single-device engine."""
    out = str(tmp_path / "qm")
    first = repro_torch.serve(repro_torch.ServeConfig(
        mesh=(1, 2), smoke=True, quantize="w8a8", kv_bits=8, save=out,
        **SERVE))
    assert first.mesh == (1, 2) and first.mesh_backend == "gloo"
    assert [r["stage"] for r in first.report][-1] == "shard"
    loaded = repro_torch.QuantizedModel.load(out, device="cpu")
    assert loaded.recipe.name == "serve-w8a8-kv8-tp"
    assert loaded.shard_mode == "tp"
    assert loaded.sharding["mesh_shape"] == [1, 2]
    assert loaded.sharding["mesh_axes"] == ["data", "model"]
    assert "'model'" in loaded.sharding["specs"]["/blocks/mlp/wu/q"]
    again = repro_torch.serve(repro_torch.ServeConfig(load=out, **SERVE))
    assert again.mesh == (1, 2)
    assert _launcher_tokens(again) == _launcher_tokens(first)
    assert _launcher_tokens(first) == _single_device_tokens(
        out, repro_torch.ServeConfig(load=out, **SERVE))
    assert len(first.rank_launches) == 2


def test_jax_tp_artifact_serves_over_its_recorded_mesh(tmp_path):
    """A JAX ``serve-w8a16-tp`` artifact saved with a 1x2 mesh: the port
    loads its sharding record (specs as JAX printed them) and serves it
    over that mesh, the single-device engine's tokens."""
    out = str(tmp_path / "jq")
    jq = repro.quantize("qwen2-0.5b-smoke", recipe="serve-w8a16-tp")
    jq.save(out, mesh=_StubMesh(data=1, model=2))
    loaded = repro_torch.QuantizedModel.load(out, device="cpu")
    assert loaded.sharding == jq.sharding
    run = repro_torch.serve(repro_torch.ServeConfig(load=out, **SERVE))
    assert run.mesh == (1, 2)
    assert _launcher_tokens(run) == _single_device_tokens(
        out, repro_torch.ServeConfig(load=out, **SERVE))


def test_port_save_records_jax_specs(tmp_path):
    """The port's ``save(mesh=)`` writes the sharding record JAX writes for
    the same artifact and mesh, leaf for leaf."""
    jq = repro.quantize("qwen2-0.5b-smoke", recipe="serve-w8a8-kv8-tp")
    tq = repro_torch.quantize("qwen2-0.5b-smoke", recipe="serve-w8a8-kv8-tp",
                              device="cpu")
    for mesh in (_StubMesh(data=1, model=2), _StubMesh(data=2, model=4)):
        jq.save(str(tmp_path / "j"), mesh=mesh)
        tq.save(str(tmp_path / "t"), mesh=mesh)
        assert tq.sharding == jq.sharding
