"""QuantizedModel artifacts and the checkpointer across the two packages.

An artifact is the checkpointer's ``step_0/`` (``manifest.json``,
``skeleton.json``, one ``arr_i.npy`` a leaf, QTensors as
``{"__qtensor_<mode>__": {"q", "scale"}}``) plus the
``quantized_model.json`` sidecar. Each package must load what the other
saves: every leaf equal (bit for bit: nothing is recomputed), the recipe,
the report and the KV precision kept. The JAX package's forward over an
artifact the port saved gives the port's logits within the model parity
tests' tolerances (``test_torch_model.py``: atol 2e-5 for fp32 weights,
1e-5 and the same greedy tokens for serve-w8a8-kv8).

The hazards the checkpointer handles, each tested here: ``arr_i`` follows
``jax.tree.flatten``'s order (dict keys sorted), and a bfloat16 leaf is read
without ``ml_dtypes`` (which the card's machine does not have) and written
so that the JAX package loads it as bfloat16.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
import repro
from _torch_port import jax_to_numpy
from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model

import repro_torch
from repro_torch import get_config
from repro_torch.checkpoint import CheckpointError, Checkpointer
from repro_torch.pipeline import PipelineError, QuantizedModel
from repro_torch.quantized import QTensor
from repro_torch.weights import from_jax_numpy

ARCH = "qwen2-0.5b-smoke"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BC_DEPLOY = ["fold_norm", "cle", "bias_absorb", "bias_correct",
             ("pack", {"mode": "w8a8"}), ("kv_cache", {"bits": 8})]


def _flat(tree, path=()):
    """{path: numpy} of a port tree (QTensor → q, scale, mode) or of
    ``jax_to_numpy``'s."""
    out = {}
    if isinstance(tree, QTensor):
        return {path + ("q",): tree.q.numpy(),
                path + ("scale",): tree.scale.numpy(),
                path + ("mode",): tree.mode}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree if isinstance(tree, (np.ndarray, str))
            else tree.numpy()}


def _assert_same_leaves(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        if isinstance(v, str):
            assert v == fb[k], k
        else:
            assert v.dtype == fb[k].dtype, k
            np.testing.assert_array_equal(v, fb[k], err_msg=str(k))


@pytest.fixture(scope="module")
def jax_init():
    jm = jax_build_model(jax_get_config("qwen2-0.5b", smoke=True))
    return jm, jm.init(jax.random.PRNGKey(0))


# ------------------------------------------------------ JAX → port

@pytest.mark.parametrize("recipe", ["dfq-int8", "serve-w8a8-kv8"])
def test_jax_artifact_loads_in_the_port(jax_init, tmp_path, recipe):
    jm, jp = jax_init
    jq = repro.quantize(jm, params=jp, recipe=recipe)
    jq.save(str(tmp_path))
    qm = QuantizedModel.load(str(tmp_path), device="cpu")
    _assert_same_leaves(qm.params, jax_to_numpy(jq.params))
    assert qm.recipe.name == recipe
    assert [(s.stage, dict(s.options)) for s in qm.recipe.steps] == [
        (s.stage, dict(s.options)) for s in jq.recipe.steps]
    assert json.dumps(qm.report, default=float) == json.dumps(
        jq.report, default=float)
    assert qm.kv_bits == (8 if recipe.endswith("kv8") else 16)
    assert jq.cfg.kv_cache_bits == (8 if recipe.endswith("kv8") else 16)
    assert qm.cfg == dataclasses.replace(get_config(ARCH),
                                         kv_cache_bits=qm.kv_bits)
    assert qm.site_sqnr_db() == jq.site_sqnr_db()


# ------------------------------------------------------ port → JAX

def _jax_roll(jm, jp, toks, kv_bits):
    cache = jm.init_cache(2, 32, dtype=jnp.float32, per_slot=True,
                          kv_bits=kv_bits)
    lg, cache = jm.prefill(jp, jnp.asarray(toks[:, :8]), cache)
    out = [np.asarray(lg)]
    decode = jax.jit(jm.decode_step)
    for t in range(8, toks.shape[1]):
        lg, cache = decode(jp, jnp.asarray(toks[:, t:t + 1]), cache)
        out.append(np.asarray(lg))
    return np.stack(out)


def _port_roll(qm, toks):
    cache = qm.init_cache(2, 32, device="cpu")
    t = torch.from_numpy(toks).long()
    lg, cache = qm.prefill(t[:, :8], cache)
    out = [lg.numpy()]
    for i in range(8, toks.shape[1]):
        lg, cache = qm.decode_step(t[:, i:i + 1], cache)
        out.append(lg.numpy())
    return np.stack(out)


@pytest.mark.parametrize("recipe", ["dfq-int8", "serve-w8a8-kv8", "bc-w8a8-kv8"])
def test_port_artifact_loads_in_jax(jax_init, tmp_path, recipe):
    """Every leaf equal, the recipe, report and KV precision kept; the JAX
    forward over it gives the port's logits (the eval forward for the
    fake-quantized dfq-int8; prefill and 4 decode steps over the int8 KV
    cache for the two w8a8 deployments)."""
    jm, jp = jax_init
    cfg = get_config(ARCH)
    spec = BC_DEPLOY if recipe == "bc-w8a8-kv8" else recipe
    qm = repro_torch.quantize(ARCH, from_jax_numpy(jax_to_numpy(jp), cfg,
                                                   device="cpu"),
                              recipe=spec, device="cpu")
    qm.save(str(tmp_path))
    jq = repro.QuantizedModel.load(str(tmp_path))
    _assert_same_leaves(qm.params, jax_to_numpy(jq.params))
    assert jq.recipe.name == qm.recipe.name
    assert [r["stage"] for r in jq.report] == [r["stage"] for r in qm.report]
    assert jq.cfg.kv_cache_bits == (16 if recipe == "dfq-int8" else 8)
    for f in dataclasses.fields(qm.cfg):
        assert getattr(jq.cfg, f.name) == getattr(qm.cfg, f.name), f.name
    toks = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    if recipe == "dfq-int8":
        lj, _ = jq.apply(jnp.asarray(toks))
        lt = qm.apply(torch.from_numpy(toks).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5, rtol=0)
        return
    lj = _jax_roll(jq.model, jq.params, toks, 8)
    lt = _port_roll(qm, toks)
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)


def test_save_load_serve_gives_the_unsaved_tokens(tmp_path):
    """The bias-corrected w8a8 deployment served after a port save → load,
    and ``serve(ServeConfig(load=...))``, give the tokens and ticks of the
    model that was never saved."""
    from repro_torch.serving import ServingEngine, synthetic_trace

    qm = repro_torch.quantize(ARCH, recipe=BC_DEPLOY, device="cpu")
    qm.save(str(tmp_path))
    loaded = QuantizedModel.load(str(tmp_path), device="cpu")
    _assert_same_leaves(loaded.params, qm.params)
    assert loaded.kv_bits == 8

    def run(q):
        engine = ServingEngine(q.model, q.params, q.cfg, num_slots=4,
                               max_len=48, prefill_chunk=16, device="cpu",
                               kv_bits=q.kv_bits)
        return engine.run(synthetic_trace(
            0, 6, vocab_size=256, prompt_lens=(4, 20), gen_lens=(4, 12),
            mean_interarrival=1.0))

    want, got = run(qm), run(loaded)
    assert [(r.tokens, r.finished_at) for r in got.values()] == [
        (r.tokens, r.finished_at) for r in want.values()]
    served = repro_torch.serve(repro_torch.ServeConfig(
        load=str(tmp_path), device="cpu", trace=6, prompt_min=4,
        prompt_len=20, gen_min=4, gen_len=12, max_len=48))
    assert served.report == qm.report
    assert [r.tokens for r in served.results.values()] == [
        r.tokens for r in want.values()]


def test_serve_load_precedence_and_refusals(tmp_path, capsys):
    """``--load`` serves the artifact as saved: an explicit differing
    arch, smoke or quantize is reported as ignored; an explicit --kv-bits
    other than the artifact's KV precision is refused (the JAX launcher's
    "must-match"); an artifact without a kv_cache stage serves the fp
    cache."""
    from repro_torch.launch.serve_config import ServeConfigError

    kv8, fp = str(tmp_path / "kv8"), str(tmp_path / "fp")
    repro_torch.quantize(ARCH, recipe="serve-w8a16-kv8", device="cpu").save(kv8)
    repro_torch.quantize(ARCH, recipe="naive-int8", device="cpu",
                         calibration=None).save(fp)
    run = repro_torch.serve(repro_torch.ServeConfig(
        load=kv8, device="cpu", quantize="w8a8", trace=2, prompt_len=8,
        gen_len=4))
    assert len(run.results) == 2
    out = capsys.readouterr().out
    assert "--quantize w8a8 ignored" in out and "quantize=w8a16" in out
    assert "--arch" not in out and "--smoke" not in out
    assert run.kv_bits == 8 and "kv cache: int8" in out
    with pytest.raises(ServeConfigError, match="kv_cache_bits=16"):
        repro_torch.serve(repro_torch.ServeConfig(load=fp, device="cpu",
                                                  kv_bits=8))
    run = repro_torch.serve(repro_torch.ServeConfig(
        load=fp, device="cpu", trace=2, prompt_len=8, gen_len=4))
    assert len(run.results) == 2 and run.kv_bits == 16
    assert "kv cache: fp" in capsys.readouterr().out
    art = repro_torch.ServeConfig.from_artifact(
        QuantizedModel.load(kv8, device="cpu"))
    assert (art.arch, art.smoke, art.quantize, art.kv_bits) == (
        "qwen2-0.5b", True, "w8a16", 8)


def test_load_missing_dir_actionable_error(tmp_path):
    with pytest.raises(PipelineError, match="quantized_model.json"):
        QuantizedModel.load(str(tmp_path / "nope"), device="cpu")


@pytest.mark.parametrize("edit,match", [
    ({"mlp_bias": True}, None),
    ({"ssm_chunk": 64, "enc_seq": 3000}, None),
    ({"rotary_scaling": 2.0}, "fields the port does not know: rotary_scaling"),
    ({"max_seq": 128, "remat": False, "logit_chunk": 32}, None),
])
def test_config_sidecar_fields(tmp_path, edit, match):
    """The port takes its own fields (the SSM and encoder-decoder ones
    among them, and ``mlp_bias``), ignores the JAX fields that do not
    change what the model computes, and refuses any it does not know."""
    d = str(tmp_path)
    repro_torch.quantize(ARCH, recipe="naive-int8", calibration=None,
                         device="cpu").save(d)
    path = os.path.join(d, "quantized_model.json")
    with open(path) as f:
        meta = json.load(f)
    meta["config"].update(edit)
    with open(path, "w") as f:
        json.dump(meta, f)
    if match is None:
        port_edit = {k: v for k, v in edit.items()
                     if k in {f.name for f in dataclasses.fields(
                         get_config(ARCH))}}
        assert QuantizedModel.load(d, device="cpu").cfg == dataclasses.replace(
            get_config(ARCH), **port_edit)
    else:
        with pytest.raises(PipelineError, match=match):
            QuantizedModel.load(d, device="cpu")


def test_mixtral_artifact_round_trips_through_both_packages(tmp_path):
    """A smoke mixtral (experts [L, E, ...], the router, the 16-position
    window, capacity_factor) quantized by each package loads in the other:
    every leaf and the config equal, and the loaded model decodes past the
    window to the saver's logits."""
    jm = jax_build_model(jax_get_config("mixtral-8x22b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("mixtral-8x22b-smoke")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jq = repro.quantize(jm, params=jp, recipe="serve-w8a8-kv8")
    jq.save(jax_dir)
    qm = QuantizedModel.load(jax_dir, device="cpu")
    _assert_same_leaves(qm.params, jax_to_numpy(jq.params))
    assert qm.cfg == dataclasses.replace(cfg, kv_cache_bits=8)
    tq = repro_torch.quantize(cfg, from_jax_numpy(jax_to_numpy(jp), cfg,
                                                  device="cpu"),
                              recipe="serve-w8a8-kv8", device="cpu")
    tq.save(port_dir)
    back = repro.QuantizedModel.load(port_dir)
    _assert_same_leaves(tq.params, jax_to_numpy(back.params))
    assert (back.cfg.n_experts, back.cfg.top_k, back.cfg.sliding_window,
            back.cfg.capacity_factor) == (4, 2, 16, 4.0)
    toks = np.random.RandomState(3).randint(0, 256, (2, 24)).astype(np.int32)
    np.testing.assert_allclose(_port_roll(qm, toks),
                               _jax_roll(back.model, back.params, toks, 8),
                               rtol=0, atol=1e-3)


class _StubMesh:
    """A JAX-side mesh for ``QuantizedModel.save(mesh=)``: its shape and
    axis names (the planner reads nothing else)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def test_jax_moe_tp_artifact_serves_over_its_recorded_mesh(tmp_path):
    """A JAX ``-tp`` MoE artifact saved with a 1x2 mesh loads with its
    shard stage's record (the specs as JAX printed them) and its int8
    weights, and ``--load`` serves it over the recorded mesh: the port's
    single-device engine's tokens on the same artifact."""
    import repro_torch
    from repro_torch.launch.serve import _requests
    from repro_torch.serving import ServingEngine, required_cache_len

    jq = repro.quantize("mixtral-8x22b-smoke", recipe="serve-w8a8-tp")
    jq.save(str(tmp_path), mesh=_StubMesh(data=1, model=2))
    qm = QuantizedModel.load(str(tmp_path), device="cpu")
    assert qm.shard_mode == "tp" and qm.sharding == jq.sharding
    assert "'model'" in qm.sharding["specs"]["/blocks/mlp/experts/wu/q"]
    _assert_same_leaves(qm.params, jax_to_numpy(jq.params))
    config = repro_torch.ServeConfig(load=str(tmp_path), device="cpu",
                                     trace=4, prompt_len=8, gen_len=6,
                                     prefill_chunk=4)
    run = repro_torch.serve(config)
    assert run.mesh == (1, 2) and len(run.rank_launches) == 2
    reqs = _requests(config, qm.cfg.vocab_size)
    need = max(required_cache_len(len(r.prompt), r.max_new_tokens, 4)
               for r in reqs)
    eng = ServingEngine.from_quantized(qm, num_slots=config.slots,
                                       max_len=need, prefill_chunk=4,
                                       device="cpu")
    want = {rid: list(r.tokens) for rid, r in eng.run(reqs).items()}
    assert {rid: list(r.tokens) for rid, r in run.results.items()} == want


# ------------------------------------------------------ the checkpointer

def _unsorted_tree(lib):
    a = lambda *v: lib(np.asarray(v, np.float32))
    return {"zeta": a(1.0), "alpha": {"y": a(2.0, 3.0), "b": a(4.0)},
            "mid": [a(5.0), {"q": a(6.0), "scale": a(7.0)}]}


def test_leaf_order_is_jax_flatten_order(tmp_path):
    """Dict keys sorted, lists in order — the order of ``arr_i`` in both
    packages, whatever order the tree's keys were inserted in."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    Checkpointer(port_dir).save(3, _unsorted_tree(torch.from_numpy),
                                blocking=True)
    JaxCheckpointer(jax_dir).save(3, _unsorted_tree(jnp.asarray),
                                  blocking=True)
    want = [[4.0], [2.0, 3.0], [5.0], [6.0], [7.0], [1.0]]
    for d in (port_dir, jax_dir):
        got = [np.load(os.path.join(d, "step_3", f"arr_{i}.npy")).tolist()
               for i in range(6)]
        assert got == want, d
    # each restores the other's, every leaf bound to its path
    tree, step = Checkpointer(jax_dir).restore_skeleton()
    assert step == 3 and float(tree["mid"][1]["scale"][0]) == 7.0
    assert tree["alpha"]["y"].tolist() == [2.0, 3.0]
    jtree, _ = JaxCheckpointer(port_dir).restore_skeleton()
    assert jtree["alpha"]["b"].tolist() == [4.0]
    assert jtree["mid"][0].tolist() == [5.0]


def test_bf16_leaf_crosses_without_ml_dtypes(tmp_path):
    """A bfloat16 leaf the JAX package saved (a '<V2' payload) is read by
    the port in a process where ``ml_dtypes`` cannot be imported; one the
    port saved loads in the JAX package as bfloat16."""
    vals = np.asarray([1.5, -2.25, 3.0e-3, 65504.0], np.float32)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxCheckpointer(jdir).save(0, {"w": vals.astype(ml_dtypes.bfloat16),
                                   "i": np.arange(3, dtype=np.int8)},
                               blocking=True)
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        f"tree, _ = Checkpointer({jdir!r}).restore_skeleton()\n"
        "assert 'ml_dtypes' not in sys.modules or sys.modules['ml_dtypes'] is None\n"
        "print(tree['w'].dtype, tree['w'].float().tolist(), tree['i'].tolist())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    want = vals.astype(ml_dtypes.bfloat16).astype(np.float32).tolist()
    assert out.stdout.strip() == f"torch.bfloat16 {want} [0, 1, 2]"

    Checkpointer(pdir).save(0, {"w": torch.from_numpy(vals).to(torch.bfloat16)},
                            blocking=True)
    jtree, _ = JaxCheckpointer(pdir).restore_skeleton()
    assert jtree["w"].dtype == jnp.bfloat16
    assert np.asarray(jtree["w"]).astype(np.float32).tolist() == want
    back, _ = Checkpointer(pdir).restore_skeleton()
    assert back["w"].dtype == torch.bfloat16 and back["w"].float().tolist() == want


def test_unreadable_leaves_are_refused_by_name(tmp_path):
    with pytest.raises(CheckpointError, match="leaf a/f8"):
        Checkpointer(str(tmp_path / "w")).save(
            0, {"a": {"f8": torch.zeros(2).to(torch.float8_e4m3fn)}},
            blocking=True)
    d = str(tmp_path / "r")
    JaxCheckpointer(d).save(0, {"x": {"f8": np.zeros(2, ml_dtypes.float8_e4m3fn)}},
                            blocking=True)
    with pytest.raises(CheckpointError, match="leaf x/f8"):
        Checkpointer(d).restore_skeleton()


def test_checkpointer_retention_async_and_tmp_cleanup(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"x": torch.full((4,), float(step))}, blocking=False)
    ck.wait()
    assert ck.latest_step() == 3
    assert sorted(os.listdir(d)) == ["step_2", "step_3"]
    tree, step = ck.restore_skeleton(2)
    assert step == 2 and tree["x"].tolist() == [2.0] * 4
    os.makedirs(os.path.join(d, "step_4.tmp-1"))
    assert Checkpointer(d).latest_step() == 3
    assert "step_4.tmp-1" not in os.listdir(d)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore_skeleton()


def test_cli_quantizes_saves_and_lists(tmp_path, capsys):
    from repro_torch.pipeline.cli import main

    d = str(tmp_path / "art")
    assert main(["--smoke", "--recipe", "cle-only", "--device", "cpu",
                 "--verbose", "--save", d]) == 0
    out = capsys.readouterr().out
    assert "recipe 'cle-only'" in out and "per-site weight SQNR" in out
    assert QuantizedModel.load(d, device="cpu").recipe.name == "cle-only"
    assert main(["--list-recipes"]) == 0
    out = capsys.readouterr().out
    assert "dfq-int8" in out and "serve-w8a8-kv8" in out
    assert main(["--list-stages"]) == 0
    assert "bias_correct" in capsys.readouterr().out
