"""The port's dry-run (``repro_torch.launch.dryrun``), its collective
recorder (``sharding.collectives.record_collectives``), ``quantized
.quantize_shapes`` and ``ModelConfig.mlp_bias``, on the CPU.

``run_cell`` traces the real step on the ``meta`` device as rank 0 of a
fake world of 256 ranks (a process-wide default group), so every dry-run
here runs in a subprocess of its own, started together at the module's
first test: the group never reaches another test of an xdist worker. One
cell a family, at full width: qwen2-0.5b ``decode_32k`` W8A16 over the
int8 cache (through the CLI, ``main``), mixtral-8x22b ``train_4k``,
mamba2-2.7b ``prefill_32k``, whisper-tiny ``train_4k`` — each ok, no CUDA
touched, the reference's keys where they mean something, and for the
decoder-only stacks ``per_layer`` × L within 2 % of the full count (the
embedding and the head lie outside the slope). The recorder: each logical collective's kind,
result bytes and count under a fake world of 4 (a group of one rank
counts nothing), and a smoke tensor-parallel decode step's bytes against
a hand count from the planner's serve-mode specs.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port import jax_to_numpy
from repro.configs import get_config as jax_get_config
from repro.core.dfq import DFQConfig as JaxDFQConfig
from repro.core.dfq import apply_dfq as jax_apply_dfq
from repro.models import build_model as jax_build_model
from repro.quantized import quantize_shapes as jax_quantize_shapes

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.dfq import DFQConfig, apply_dfq
from repro_torch.models import build_model
from repro_torch.quantized import QTensor, quantize_for_serving, quantize_shapes
from repro_torch.weights import from_jax_numpy

HERE = pathlib.Path(__file__).resolve().parent
ARCHS = list_archs()
# per_layer × L against the full count: the embedding and the head are
# outside the slope (measured 0.0-0.6 % at these cells)
SLOPE_TOL = 0.02

_SCRIPT = r'''
import json, sys
import torch

task, out = sys.argv[1], sys.argv[2]
from repro_torch.launch import dryrun

def done(result):
    result["cuda_initialized"] = torch.cuda.is_initialized()
    with open(out, "w") as f:
        json.dump(result, f)

if task == "qwen2-cli":
    dryrun.RESULTS_DIR = sys.argv[3]
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--mesh", "single", "--quantized", "--kv8"])
    path = dryrun.cell_path("qwen2-0.5b", "decode_32k", False, "_w8a16_kv8")
    with open(path) as f:
        done({"rc": rc, "cell": json.load(f), "path": path})
elif task == "recorder":
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import ShapeConfig, build_model
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.partition import spec_paths
    from repro_torch.sharding.tp import ServeShard

    def rec(fn):
        with coll.record_collectives() as r:
            fn()
        return {"bytes": r.bytes, "counts": r.counts, "total": r.total}

    def meta(*shape, grad=False, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta",
                           requires_grad=grad)

    def bwd(y):
        y.backward(torch.empty_like(y))

    res = {}
    with dryrun.fake_mesh((2, 2)) as mesh:
        g, dg = mesh.get_group("model"), mesh.get_group("data")
        res["all_reduce_sum"] = rec(lambda: coll.all_reduce_sum(meta(3, 5), g))
        res["all_reduce_max"] = rec(lambda: coll.all_reduce_max(meta(3, 5), g))
        res["all_gather"] = rec(lambda: coll.all_gather(meta(3, 5), 0, g))
        res["combine"] = rec(lambda: coll.combine(meta(3, 5), g))
        res["argmax"] = rec(lambda: coll.argmax(meta(3, 5), 0, g))
        res["any_true"] = rec(lambda: coll.any_true(meta(3, dtype=torch.bool), g))
        res["fsdp_gather"] = rec(lambda: bwd(coll.fsdp_gather(
            meta(3, 5, grad=True), 0, dg, dg)))
        res["grad_sum"] = rec(lambda: bwd(coll.grad_sum(meta(3, 5, grad=True), g)))
        res["sum_forward"] = rec(lambda: bwd(coll.sum_forward(
            meta(3, 5, grad=True), g)))
        res["gather_forward"] = rec(lambda: bwd(coll.gather_forward(
            meta(3, 5, grad=True), 0, g)))
        res["scatter_forward"] = rec(lambda: bwd(coll.scatter_forward(
            meta(6, 5, grad=True), 0, g)))
        try:
            with dryrun.fake_mesh((2, 2)):
                pass
        except RuntimeError as e:
            res["refused"] = str(e)
    res["destroyed"] = not dist.is_initialized()
    with dryrun.fake_mesh((4, 1)) as mesh:
        res["one_rank"] = rec(lambda: coll.all_gather(
            meta(3, 5), 0, mesh.get_group("model")))
    # a smoke tensor-parallel decode step at 1x2, against the planner
    cfg = dataclasses.replace(get_config("qwen2-0.5b-smoke"), d_model=128,
                              d_ff=256, vocab_size=512, n_heads=4,
                              n_kv_heads=2, head_dim=32)
    shape = ShapeConfig("d", 64, 4, "decode")
    with dryrun.fake_mesh((1, 2)) as mesh:
        tr = dryrun.trace_step(cfg, shape, mesh)
        shard = ServeShard(mesh, cfg, build_model(cfg).init(0, device="meta"),
                           num_slots=4, paged=False, backend="fake")
        specs = {p: [a for a in s] for p, s in spec_paths(shard.specs)}
    res["tp"] = {"collectives": tr.collectives, "specs": specs,
                 "head_local": shard.head_local, "n_layers": cfg.n_layers,
                 "rows": shard.slot_hi - shard.slot_lo, "d_model": cfg.d_model}
    done(res)
elif task == "smoke-2x4":
    # tests/test_dryrun_smoke.py's cells: four smoke archs widened, a
    # train and a decode step each over a (2, 4) data x model mesh
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ShapeConfig
    res = {}
    with dryrun.fake_mesh((2, 4)) as mesh:
        for arch in ("qwen2-0.5b", "mixtral-8x22b", "mamba2-2.7b",
                     "whisper-tiny"):
            cfg = dataclasses.replace(
                get_config(arch + "-smoke"), d_model=128, d_ff=256,
                vocab_size=512, n_heads=4, n_kv_heads=2, head_dim=32)
            for name, shape in (("train", ShapeConfig("t", 32, 8, "train")),
                                ("decode", ShapeConfig("d", 64, 8, "decode"))):
                tr = dryrun.trace_step(cfg, shape, mesh)
                res[f"{arch}.{name}"] = {
                    "temp": tr.temp_bytes, "argument": tr.argument_bytes,
                    "flops": tr.flops, "collectives": tr.collectives["total"]}
    done(res)
else:
    arch, shape = task.split(":")
    done(dryrun.run_cell(arch, shape, False))
'''

CELLS = {"qwen2-0.5b decode_32k (CLI)": "qwen2-cli",
         "mixtral-8x22b train_4k": "mixtral-8x22b:train_4k",
         "mamba2-2.7b prefill_32k": "mamba2-2.7b:prefill_32k",
         "whisper-tiny train_4k": "whisper-tiny:train_4k"}


class _Runs:
    """The subprocesses, started together; each result read when asked."""

    def __init__(self, tmp):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent / "src"),
                                             env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = "1"
        self.procs, self.outs, self.logs = {}, {}, {}
        for task in list(CELLS.values()) + ["recorder", "smoke-2x4"]:
            name = task.replace(":", "_")
            extra = [str(tmp / "results")] if task == "qwen2-cli" else []
            self.outs[task] = tmp / (name + ".json")
            self.logs[task] = tmp / (name + ".log")
            with open(self.logs[task], "wb") as log:
                self.procs[task] = subprocess.Popen(
                    [sys.executable, "-c", _SCRIPT, task,
                     str(self.outs[task]), *extra],
                    env=env, cwd=str(tmp), stdout=log,
                    stderr=subprocess.STDOUT)
        self.results = {}

    def get(self, task):
        if task not in self.results:
            self.procs[task].wait(timeout=600)
            log = self.logs[task].read_text()
            assert self.procs[task].returncode == 0, log[-4000:]
            with open(self.outs[task]) as f:
                self.results[task] = json.load(f)
        return self.results[task]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("dryrun"))
    try:
        yield r
    finally:
        r.close()


# ------------------------------------------------------------- the cells
@pytest.mark.parametrize("cell", list(CELLS))
def test_run_cell_at_full_width_on_meta(cell, runs):
    """The cell traces ok on meta tensors with no CUDA touched; the memory
    keys are the reference's but the two with no counterpart; the roofline
    keys are there and finite; ``per_layer`` × L is the full count but the
    embedding's and the head's share (``SLOPE_TOL``)."""
    got = runs.get(CELLS[cell])
    r = got["cell"] if "cell" in got else got
    assert r["status"] == "ok", r
    assert got["cuda_initialized"] is False
    assert set(r["memory"]) == {"argument_size_in_bytes",
                                "output_size_in_bytes", "temp_size_in_bytes",
                                "alias_size_in_bytes"}
    assert "hlo_len" not in r
    assert r["hbm_used_per_device"] == (r["memory"]["argument_size_in_bytes"]
                                        + r["memory"]["temp_size_in_bytes"])
    assert r["fits_hbm"] == (r["hbm_used_per_device"] < 80e9)
    assert r["mesh"] == "16x16" and r["chips"] == 256
    for k in ("compute_s", "memory_s", "memory_analytic_s", "collective_s",
              "bound_time_s", "model_flops", "flops_global",
              "useful_flops_ratio", "roofline_fraction"):
        assert np.isfinite(r["roofline"][k]) and r["roofline"][k] >= 0, k
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    cost = r["cost"]
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert cost["collective_bytes"] == r["collectives"]["total"]
    cfg = get_config(r["arch"])
    for k in ("flops", "bytes"):
        layers = cost["per_layer"][k] * cfg.n_layers
        assert 0 < layers < cost[k], k
        if not cfg.is_encdec:
            # a uniform stack (whisper-tiny's 4 + 4 layers are not: its
            # vocabulary head outweighs them)
            assert cost[k] - layers <= SLOPE_TOL * cost[k], k


def test_cli_writes_the_quantized_decode_cell(runs):
    """``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
    decode_32k --mesh single --quantized --kv8`` exits 0 and writes the
    cell under the reference's tag; the decode step donates the int8
    cache, and the planner's blocks make its arguments."""
    got = runs.get("qwen2-cli")
    assert got["rc"] == 0
    assert got["path"].endswith("qwen2-0.5b__decode_32k__single_w8a16_kv8.json")
    r = got["cell"]
    assert r["placement"] == "serve"
    mem = r["memory"]
    # the cache's share: 24 layers x 8 slots x 32768 positions x 2 KV
    # heads x (64 int8 + a float32 scale), K and V, and kpos / pos
    cache = 2 * 24 * 8 * 32768 * 2 * (64 + 4) + 8 * 32768 * 8 + 8 * 8
    assert mem["alias_size_in_bytes"] == cache
    assert mem["argument_size_in_bytes"] > cache
    # one all-reduce a layer (the row-parallel down projection; 14 heads
    # do not divide 16: the attention's projections are whole) and the
    # vocab-parallel embedding's
    assert r["collectives"]["counts"]["all-reduce"] == 24 + 1


def test_train_cells_donate_params_and_moments(runs):
    """A train cell's alias bytes are its params and both AdamW moments
    (float32 blocks); its collectives gather layers (FSDP) and all-reduce
    their gradients whole over "data" (what the port runs, not XLA's
    reduce-scatter) and the activations over "model" (TP). Its temp bytes leave
    out the whole params and moments the step draws on meta for the
    shard's specs (no memory on the card either), which would be 12 bytes
    a parameter (1.69 TB for mixtral)."""
    r = runs.get("mixtral-8x22b:train_4k")
    mem = r["memory"]
    assert mem["temp_size_in_bytes"] < 4 * get_config(
        "mixtral-8x22b").param_count()
    assert mem["alias_size_in_bytes"] > 0
    assert mem["argument_size_in_bytes"] - mem["alias_size_in_bytes"] == (
        4 + 2 * 256 * 4096 * 4 // 16)      # the step, this rank's rows
    counts = r["collectives"]["counts"]
    assert set(counts) == {"all-gather", "all-reduce"}
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert r["placement"] == "train"


def test_ssm_prefill_runs_data_parallel(runs):
    """mamba2's prefill runs data-parallel (the port's serving forward
    runs no SSM tensor-parallel): two of the 32 rows on this rank, every
    weight whole, no collective."""
    r = runs.get("mamba2-2.7b:prefill_32k")
    assert r["placement"] == "data-parallel"
    assert r["collectives"]["total"] == 0


SMOKE_CELLS = [f"{a}.{k}" for a in ("qwen2-0.5b", "mixtral-8x22b",
                                    "mamba2-2.7b", "whisper-tiny")
               for k in ("train", "decode")]


@pytest.mark.parametrize("cell", SMOKE_CELLS)
def test_multidevice_smoke_cells(cell, runs):
    """The reference's ``tests/test_dryrun_smoke.py`` (red on this jax:
    its ``Explicit`` mesh axes) lowers a train and a decode step of four
    smoke archs over a (2, 4) mesh and reads their temp bytes; the port
    traces the same cells over a fake (2, 4) world: each counts FLOPs,
    holds arguments and allocates temp bytes; a (2, 4) step collects over
    its axes but for the SSM's and the encoder-decoder's data-parallel
    decode."""
    r = runs.get("smoke-2x4")[cell]
    assert r["temp"] > 0 and r["argument"] > 0 and r["flops"] > 0
    assert (r["collectives"] == 0) == (cell in ("mamba2-2.7b.decode",
                                                "whisper-tiny.decode"))


# ----------------------------------------------------------- the recorder
# (kind, result bytes, count) of each logical collective on a float32
# [3, 5] (60 bytes) over a model axis of 2, forward and backward
RECORDED = {
    "all_reduce_sum": {"all-reduce": (60, 1)},
    "all_reduce_max": {"all-reduce": (60, 1)},
    "all_gather": {"all-gather": (120, 1)},
    "combine": {"all-reduce": (60, 1)},
    # the max of the maxes (float32 [3]) and the least index (int64 [3])
    "argmax": {"all-reduce": (12 + 24, 2)},
    "any_true": {"all-reduce": (12, 1)},
    # forward the gather, backward the whole gradient's sum (then cut to
    # the block)
    "fsdp_gather": {"all-gather": (120, 1), "all-reduce": (120, 1)},
    "grad_sum": {"all-reduce": (60, 1)},
    "sum_forward": {"all-reduce": (60, 1)},
    "gather_forward": {"all-gather": (120, 1)},
    # backward: the [3, 5] gradient blocks gathered to [6, 5]
    "scatter_forward": {"all-gather": (120, 1)},
}


@pytest.mark.parametrize("name", list(RECORDED))
def test_each_logical_collective_is_recorded_once(name, runs):
    got = runs.get("recorder")[name]
    want = {k: (0, 0) for k in ("all-gather", "all-reduce")}
    want.update(RECORDED[name])
    assert {k: (got["bytes"][k], got["counts"][k]) for k in want} == want
    assert got["total"] == sum(b for b, _ in want.values())


def test_fake_world_is_refused_twice_and_destroyed(runs):
    """A fake world refuses to start inside another, is destroyed on
    leaving, and a group of one rank records nothing."""
    got = runs.get("recorder")
    assert "process group already exists" in got["refused"]
    assert got["destroyed"]
    assert got["one_rank"]["total"] == 0


def test_tp_decode_collectives_are_the_planners(runs):
    """A smoke tensor-parallel decode step at 1x2 (qwen2 widened so that
    the planner cuts): one all-reduce of the rows' [B, 1, D] activations a
    projection whose serve-mode spec puts its in dim on "model" (o and
    down), and one for the vocab-parallel embedding; head-local attention
    gathers nothing."""
    tp = runs.get("recorder")["tp"]
    specs = tp["specs"]
    row_cut = [n for n in ("attn/wo", "mlp/wd")
               if specs[f"/blocks/{n}"][-2] == "model"]
    assert row_cut == ["attn/wo", "mlp/wd"] and tp["head_local"]
    assert specs["/embed"][0] == "model"
    n = tp["n_layers"] * len(row_cut) + 1
    act = tp["rows"] * tp["d_model"] * 4           # float32 smoke compute
    c = tp["collectives"]
    assert (c["all-reduce"], c["counts"]["all-reduce"]) == (n * act, n)
    assert c["all-gather"] == 0


# ------------------------------------------------------------ quantize_shapes
def _shapes(tree, path=""):
    """{path: (shape, dtype name)} and {path: mode} of either package's
    tree of shapes (a QTensor's payload and scale at /q and /scale)."""
    leaves, modes = {}, {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            sub, m = _shapes(v, f"{path}/{k}")
            leaves.update(sub)
            modes.update(m)
        return leaves, modes
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        modes[path] = tree.mode
        for k in ("q", "scale"):
            sub, _ = _shapes(getattr(tree, k), f"{path}/{k}")
            leaves.update(sub)
        return leaves, modes
    return {path: (tuple(tree.shape),
                   str(tree.dtype).replace("torch.", ""))}, modes


@pytest.mark.parametrize("mode,per_channel", [("w8a16", False),
                                              ("w8a8", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_shapes_matches_jax(arch, mode, per_channel):
    """Every leaf path, shape and dtype, and every QTensor's mode, equal
    the JAX ``quantize_shapes`` over ``jax.eval_shape(model.init, key)``;
    the port's are meta tensors."""
    jm = jax_build_model(jax_get_config(arch))
    want = jax_quantize_shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                               jm.dfq_plan(), mode=mode,
                               per_channel=per_channel)
    m = build_model(get_config(arch))
    got = quantize_shapes(m.init(0, device="meta"), m.dfq_plan(), mode=mode,
                          per_channel=per_channel)
    assert _shapes(got) == _shapes(want)
    assert all(t.device.type == "meta" for t in _meta_leaves(got))


def _meta_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _meta_leaves(v)]
    if isinstance(tree, QTensor):
        return [tree.q, tree.scale]
    return [tree]


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_shapes_is_the_pack_without_the_numbers(per_channel):
    """On a smoke model, the shapes are ``quantize_for_serving``'s leaf for
    leaf: paths, shapes, dtypes, modes and the payload's K-major strides."""
    m = build_model(get_config("qwen2-0.5b-smoke"))
    real = quantize_for_serving(m.init(0, device="cpu"), m.dfq_plan(),
                                mode="w8a8", per_channel=per_channel)
    meta = quantize_shapes(m.init(0, device="meta"), m.dfq_plan(),
                           mode="w8a8", per_channel=per_channel)
    assert _shapes(meta) == _shapes(real)
    for r, s in zip(_meta_leaves(real), _meta_leaves(meta)):
        assert r.stride() == s.stride()


# --------------------------------------------------------------- mlp_bias
def _fields(op):
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in vars(op).items() if v is not None}


@pytest.mark.parametrize("act", ["relu", "silu_glu"])
def test_mlp_bias_plan_and_forward_match_jax(act):
    """``mlp_bias=True`` on smoke qwen2 with an MLP up bias ``mlp/bu``
    (seeded, in both trees): the DFQ plans equal op for op (the MLP pair's
    ``b1`` is ``mlp/bu``), the eval forward's logits within 1e-5, and
    ``apply_dfq`` (CLE rescaling the bias, absorption shifting it) gives
    the reference's leaves within 1e-5 of each leaf's scale."""
    over = dict(act=act, mlp_bias=True)
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               **over)
    cfg = dataclasses.replace(get_config("qwen2-0.5b-smoke"), **over)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jp = jax_to_numpy(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jp["blocks"]["mlp"]["bu"] = rng.normal(
        0.0, 0.5, (cfg.n_layers, cfg.d_ff)).astype(np.float32)
    tp = from_jax_numpy(jp, cfg, device="cpu")
    jplan, tplan = jm.dfq_plan(), tm.dfq_plan()
    assert [type(o).__name__ for o in tplan.ops] == [
        type(o).__name__ for o in jplan.ops]
    for t, j in zip(tplan.ops, jplan.ops):
        assert _fields(t) == _fields(j), type(t).__name__
    pair = next(o for o in tplan.ops if type(o).__name__ == "DensePairOp")
    assert tuple(pair.b1) == ("blocks", "mlp", "bu")
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    jp_j = jax.tree.map(jnp.asarray, jp)
    want = np.asarray(jm.apply(jp_j, jnp.asarray(tokens))[0])
    got = tm.apply(tp, torch.as_tensor(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    je = jax_to_numpy(jax_apply_dfq(jp_j, jplan, JaxDFQConfig()))
    te = apply_dfq(tp, tplan, DFQConfig())
    for k in ("wu", "bu", "wd", "bd"):
        w, g = je["blocks"]["mlp"][k], te["blocks"]["mlp"][k].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
