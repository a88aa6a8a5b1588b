"""The port's training over a mesh (``launch.steps`` under
``configure_sharding_hints``; ``sharding.train``) against the JAX package's
sharded step, on the CPU.

The oracle is the reference's jitted step on a ("data", "model") mesh of
``AxisType.Auto`` axes over 8 forced host devices, run unedited in a
subprocess (``_jax_sharded_train.py``) while the port's ranks run here
(``_torch_sharded.run_ranks``: gloo rank groups of 2 and 4, every case of
a world in one group). The configs are the smoke ones widened to d_model
128, d_ff 256, vocab 512, heads 4/2 of 32 (the SSM's widths alone), so
that the planner cuts leaves over both axes (``MIN_SHARD_DIM`` is 128):
qwen2 at 2x1, 1x2, 2x2 and, with 6 q heads, 1x4 (sequence-parallel
attention, keys and values whole: ``kv_heads_ok`` false), mixtral and
llama4 (its shared expert's ``bd / n``) at 1x2 and 2x2, mamba2 and whisper
at 2x2; three steps of ``token_batch`` 8 x 32 from the JAX init.

Tolerances (``TRAIN_TOL``, as ``test_torch_train``'s): each loss and grad
norm within 1e-5 relative, params and moments within 1e-5 of their scale
plus 1e-6 (a key bias within 2 x the learning rates' sum: its gradient is
float32 noise in both packages). Measured: losses within 2e-7 relative.
The reference's sharded MoE is not its unsharded MoE where the data axis
is larger than 1 (its Switch aux loss is each data shard's, averaged):
mixtral's 2x2 loss is 2.6e-5 off the unsharded one, and the port follows
the sharded reference.
"""
import dataclasses
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
from _torch_port import jax_to_numpy
from _torch_sharded import RaiseOnRank, run_ranks
from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.data import token_batch as jax_token_batch
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.optim import adamw_init as jax_adamw_init

from repro_torch import get_config
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import steps, train
from repro_torch.models import ShapeConfig, build_model, layers
from repro_torch.optim import adamw_init
from repro_torch.runtime import elastic_restore
from repro_torch.sharding.partition import spec_paths

HERE = pathlib.Path(__file__).resolve().parent
TRAIN_TOL = (1e-5, 1e-6)
LR = {"peak_lr": 1e-3, "warmup": 2, "total": 10}
WIDE = dict(d_model=128, d_ff=256, vocab_size=512, n_heads=4, n_kv_heads=2,
            head_dim=32)
SSM_WIDE = dict(d_model=128, d_ff=256, vocab_size=512)
STEPS, BATCH, SEQ = 3, 8, 32
CASES = {
    "qwen2-2x1": ("qwen2-0.5b", WIDE, (2, 1)),
    "qwen2-1x2": ("qwen2-0.5b", WIDE, (1, 2)),
    "qwen2-2x2": ("qwen2-0.5b", WIDE, (2, 2)),
    "qwen2-h6-1x4": ("qwen2-0.5b", {**WIDE, "n_heads": 6}, (1, 4)),
    "mixtral-1x2": ("mixtral-8x22b", WIDE, (1, 2)),
    "mixtral-2x2": ("mixtral-8x22b", WIDE, (2, 2)),
    "llama4-1x2": ("llama4-scout-17b-a16e", WIDE, (1, 2)),
    "llama4-2x2": ("llama4-scout-17b-a16e", WIDE, (2, 2)),
    "mamba2-2x2": ("mamba2-2.7b", SSM_WIDE, (2, 2)),
    "whisper-2x2": ("whisper-tiny", WIDE, (2, 2)),
    # 6 heads and 18 encoder frames over a model axis of 4: the decoder's
    # 32 positions split (sequence-parallel), the encoder's do not (every
    # rank attends over all of them, whole)
    "whisper-h6-1x4": ("whisper-tiny", {**WIDE, "n_heads": 6, "enc_seq": 18},
                       (1, 4)),
}
# the full config's compute: bf16 activations over float32 params, remat
# on; the reference's one device beside its 2x1 and 1x2 (the port's one
# device runs in the test process), at the card's train batch (phase 15a's
# 8 x 256 of the Zipf stream: about half the ids are token 0, so one row
# of the embedding's gradient sums about 1,100 rows in bf16)
BF16 = {**WIDE, "dtype": "bfloat16", "param_dtype": "float32", "remat": True}
BF16_CASES = {f"qwen2-bf16-{d}x{m}": ("qwen2-0.5b", BF16, (d, m))
              for d, m in ((1, 1), (2, 1), (1, 2))}
BF16_SEQ = 256
# the reference's own 2x1 grad norm moves off its one device by more than
# BF16_MOVE (measured, 3 steps: 6.50 / 5.21 / 2.86 %; the port on the H100
# at full width 1.76-2.43 %), and the port follows it within BF16_GAP,
# relative: its grad norm against the reference's at each mesh (measured
# at most 8.5e-4 over 1x1, 2x1 and 1x2) and its own move against the
# reference's (at most 7.6e-4). A port that summed the table's rows in
# float32 fails the gap at one device
BF16_MOVE = 1e-2
BF16_GAP = 2e-3


def _seq(name):
    return BF16_SEQ if name in BF16_CASES else SEQ


class StubMesh:
    """A mesh of axis sizes alone: what the planners read."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))


def _jax_cfg(arch, overrides):
    return dataclasses.replace(jax_get_config(arch, smoke=True), **overrides)


def _port_cfg(arch, overrides):
    return dataclasses.replace(get_config(arch, smoke=True), **overrides)


def _flat(tree, path=()):
    """[(path, numpy leaf)] in sorted-key order (tuples and NamedTuples in
    order), either package's tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _flat(t, path + (i,))]
    if isinstance(tree, torch.Tensor):
        return [(path, tree.detach().numpy())]
    return [(path, np.asarray(tree))]


def _assert_trees(got, want, tol=TRAIN_TOL, lr_sum=0.0, what=""):
    gl, wl = _flat(got), _flat(want)
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        atol = tol[0] * float(np.abs(w).max(initial=0.0)) + tol[1]
        if lr_sum and path[0] == 0 and path[-1] == "bk":
            atol = 2 * lr_sum
        assert g.shape == w.shape, (what, path)
        np.testing.assert_allclose(
            g.astype(np.float64), w.astype(np.float64), rtol=0, atol=atol,
            err_msg=f"{what}: {'/'.join(map(str, path))}")


def _assert_equal_trees(got, want, what=""):
    gl, wl = _flat(got), _flat(want)
    assert len(gl) == len(wl), what
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and np.array_equal(g, w), (what, path)


# ------------------------------------------------------------- the runs
class _Oracle:
    def __init__(self, proc, out, init):
        self.proc, self.out, self.init = proc, out, init
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            log, _ = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, log.decode()[-4000:]
            with open(self.out, "rb") as f:
                self._result = pickle.load(f)
        return self._result


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX sharded step of every case, started in a subprocess (8
    forced host devices, its own XLA flags) while the port runs; the JAX
    inits, drawn here, feed both."""
    d = tmp_path_factory.mktemp("oracle")
    cases = {name: dict(arch=arch, overrides=ov, mesh=mesh, steps=STEPS,
                        batch=BATCH, seq=_seq(name), lr=LR)
             for name, (arch, ov, mesh) in {**CASES, **BF16_CASES}.items()}
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           env.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "_jax_sharded_train.py"),
         str(d / "cases.pkl"), str(d / "out.pkl")],
        env=env, cwd=str(HERE.parent), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    init = {name: jax_to_numpy(jax_build_model(_jax_cfg(arch, ov)).init(
        jax.random.PRNGKey(0)))
        for name, (arch, ov, _) in {**CASES, **BF16_CASES}.items()}
    o = _Oracle(proc, d / "out.pkl", init)
    try:
        yield o
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX train checkpoint (qwen2 widened, one unsharded step) and its
    (params, AdamWState)."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    jm, jstep = jax_steps.make_train_step(_jax_cfg("qwen2-0.5b", WIDE),
                                         lr_cfg=LR)
    jp = jm.init(jax.random.PRNGKey(0))
    jp, jopt, _ = jax.jit(jstep)(jp, jax_adamw_init(jp),
                                 jax_token_batch(0, 0, 0, BATCH, SEQ, 512))
    JaxCheckpointer(str(d)).save(1, (jp, jopt), blocking=True)
    return str(d), (jp, jopt)


@pytest.fixture(scope="module")
def port_runs(oracle, jax_ckpt, tmp_path_factory):
    """Every rank task, a world's tasks in one rank group: the cases, the
    planted double count, the checkpoint round trips."""
    d = tmp_path_factory.mktemp("port")
    q = dict(arch="qwen2-0.5b-smoke", params=oracle.init["qwen2-2x2"],
             overrides=WIDE)
    tasks = {2: [], 4: []}
    sharded_bf16 = {k: v for k, v in BF16_CASES.items() if v[2] != (1, 1)}
    for name, (arch, ov, mesh) in {**CASES, **sharded_bf16}.items():
        tasks[mesh[0] * mesh[1]].append((name, "train", mesh, dict(
            arch=arch + "-smoke", params=oracle.init[name], overrides=ov,
            steps=STEPS, batch=BATCH, seq=_seq(name), lr=LR)))
    tasks[4].append(("double", "train", (2, 2), dict(
        q, steps=1, batch=BATCH, seq=SEQ, lr=LR, plant="double_count")))
    tasks[4].append(("remat-thread", "train", (2, 2), dict(
        q, overrides={**WIDE, "remat": True}, steps=STEPS, batch=BATCH,
        seq=SEQ, lr=LR, backward_thread=True)))
    tasks[2] += [
        ("save-2x1", "ckpt_save", (2, 1), dict(q, directory=str(d / "a"),
                                               lr=LR)),
        ("restore-1x2", "ckpt_restore", (1, 2), dict(
            q, directory=str(d / "a"), resave=str(d / "b")))]
    tasks[4] += [
        ("jax-onto-2x2", "ckpt_restore", (2, 2), dict(
            q, directory=jax_ckpt[0])),
        ("save-2x2", "ckpt_save", (2, 2), dict(q, directory=str(d / "c"),
                                               lr=LR))]
    out = {"dirs": {k: str(d / k) for k in "abc"}}
    for world, ts in tasks.items():
        out.update(run_ranks(world, ts,
                             tmp_path_factory.mktemp(f"ranks{world}"),
                             timeout=900))
    return out


# ----------------------------------------------------- against the oracle
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_matches_jax_sharded_step(name, oracle, port_runs):
    """Three sharded steps: each loss and grad norm within 1e-5 relative of
    the reference's sharded step at the same mesh, the learning rates
    equal, the final params and AdamW moments within ``TRAIN_TOL``."""
    got, want = port_runs[name], oracle.result()[name]
    lr_sum = 0.0
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=TRAIN_TOL[0])
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=TRAIN_TOL[0])
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        lr_sum += g["lr"]
    _assert_trees(got["final"], want["final"], lr_sum=lr_sum, what=name)


@pytest.fixture(scope="module")
def bf16_one_device(oracle):
    """The port's one-device steps in the full config's bf16 compute,
    from the reference's init: the metrics."""
    from repro_torch.data import token_batch

    name = "qwen2-bf16-1x1"
    arch, ov, _ = BF16_CASES[name]
    cfg = _port_cfg(arch, ov)
    model, step = steps.make_train_step(cfg, lr_cfg=LR)
    from repro_torch.weights import from_jax_numpy

    params = from_jax_numpy(oracle.init[name], cfg, device="cpu")
    state, metrics = (params, adamw_init(params)), []
    for s in range(STEPS):
        *state, m = step(*state, token_batch(0, s, 0, BATCH, BF16_SEQ,
                                             cfg.vocab_size, device="cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _rel(a, b):
    return abs(a / b - 1)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_bf16_sharded_step_moves_as_the_reference_does(mesh, oracle,
                                                       port_runs,
                                                       bf16_one_device):
    """In the full config's compute (bf16 activations, float32 params,
    remat on) at the card's train batch, a sharded step is not one
    device's step in either package: both sum the embedding's gradient
    rows in bf16 (below), and the cut changes how many rows of the one
    frequent token a sum holds. The reference's 2x1 grad norm moves off
    its own one device by more than ``BF16_MOVE``; the port's moves by as
    much, within ``BF16_GAP`` of the reference's move, and its grad norm
    stays within ``BF16_GAP`` of the reference's at every mesh: the gap is
    the reference's, mirrored. Losses within 1e-4 relative."""
    res = oracle.result()
    jax_one = res["qwen2-bf16-1x1"]["metrics"]
    jax_sh = res[f"qwen2-bf16-{mesh}"]["metrics"]
    port_sh = port_runs[f"qwen2-bf16-{mesh}"]["metrics"]
    for j1, js, p1, ps in zip(jax_one, jax_sh, bf16_one_device, port_sh,
                              strict=True):
        jax_move = js["grad_norm"] / j1["grad_norm"]
        port_move = ps["grad_norm"] / p1["grad_norm"]
        if mesh == "2x1":
            assert jax_move - 1 > BF16_MOVE
        assert abs(port_move / jax_move - 1) < BF16_GAP
        assert _rel(ps["grad_norm"], js["grad_norm"]) < BF16_GAP
        assert _rel(p1["grad_norm"], j1["grad_norm"]) < BF16_GAP
        for a, b in ((js, j1), (ps, p1), (ps, js)):
            assert _rel(a["loss"], b["loss"]) < 1e-4
        assert ps["lr"] == pytest.approx(js["lr"], rel=1e-6)


def test_bf16_embedding_gradient_accumulates_as_jax():
    """The embedding gradient of bf16 rows gathered from a float32 table
    cast to bf16 (``cast_for_compute`` then the lookup, both packages):
    PyTorch's backward sums repeated tokens' rows in bf16 exactly as the
    reference's transposed gather does — bit for bit, 1.9 % off the exact
    sum at 4096 rows over 16 tokens."""
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 16, 4096)
    g = torch.tensor(rng.standard_normal((4096, 64)).astype(np.float32))
    g = g.bfloat16()
    e = torch.zeros(512, 64, requires_grad=True)
    (got,) = torch.autograd.grad(e.bfloat16()[torch.as_tensor(tok)], e, g)
    import jax.numpy as jnp

    _, vjp = jax.vjp(lambda t: t.astype(jnp.bfloat16)[jnp.asarray(tok)],
                     jnp.zeros((512, 64), jnp.float32))
    (want,) = vjp(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = np.zeros((512, 64))
    np.add.at(exact, tok, g.float().numpy().astype(np.float64))
    err = np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact)
    assert 1e-2 < err < 3e-2


def test_moe_follows_the_sharded_reference(oracle, port_runs):
    """mixtral at 2x2: the reference's sharded loss is not its unsharded
    one (each data shard's aux loss, averaged), and the port's sharded
    step follows the sharded one."""
    arch, ov, _ = CASES["mixtral-2x2"]
    jm, jstep = jax_steps.make_train_step(_jax_cfg(arch, ov), lr_cfg=LR)
    jp = jm.init(jax.random.PRNGKey(0))
    _, _, m = jax.jit(jstep)(jp, jax_adamw_init(jp),
                             jax_token_batch(0, 0, 0, BATCH, SEQ, 512))
    sharded = oracle.result()["mixtral-2x2"]["metrics"][0]["loss"]
    port = port_runs["mixtral-2x2"]["metrics"][0]["loss"]
    assert abs(float(m["loss"]) / sharded - 1) > 2 * TRAIN_TOL[0]
    assert abs(port / sharded - 1) < TRAIN_TOL[0] / 10


@pytest.mark.parametrize("name", list(CASES))
def test_state_specs_and_shardings_for_match_jax(name, oracle):
    """``state_specs`` and ``shardings_for`` (a train cell), spec for spec
    as strings, against the reference's on the same mesh shape; the shapes
    are meta tensors (nothing allocated)."""
    arch, ov, mesh = CASES[name]
    cfg = _port_cfg(arch, ov)
    want = oracle.result()[name]
    (pshape, oshape), (p_spec, o_spec) = steps.state_specs(
        build_model(cfg), StubMesh(mesh))
    assert all(t.device.type == "meta" for _, t in _flat_tensors(pshape))
    got = ({p: str(s) for p, s in spec_paths(p_spec)},
           {p: str(s) for p, s in spec_paths(o_spec)})
    assert got == want["state_specs"]
    sh = steps.shardings_for(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                             StubMesh(mesh))
    for k in ("params", "opt"):
        assert {p: str(s.spec) for p, s in _sharding_paths(sh[k])} == \
            want["shardings_for"][k], k
    assert str(sh["batch"].spec) == want["shardings_for"]["batch"]


def _flat_tensors(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _flat_tensors(v, f"{path}/{k}")]
    return [(path, tree)]


def _sharding_paths(tree, prefix=""):
    from repro_torch.sharding.partition import NamedSharding

    if isinstance(tree, NamedSharding):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _sharding_paths(v, f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _sharding_paths(v, f"{prefix}/{i}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (1, 1)])
@pytest.mark.parametrize("arch,ov", [("qwen2-0.5b", WIDE),
                                     ("qwen2-0.5b", {**WIDE, "n_heads": 6}),
                                     ("mamba2-2.7b", {"n_heads": 0})])
def test_configure_sharding_hints_arms_the_reference_modes(arch, ov, shape):
    """The shard context each package's ``configure_sharding_hints`` arms
    (head-parallel or sequence-parallel, ``kv_heads_ok``; an SSM none),
    and ``clear_sharding_hints`` disarms it."""
    mesh = StubMesh(shape)
    jax_steps.configure_sharding_hints(_jax_cfg(arch, ov), mesh)
    steps.configure_sharding_hints(_port_cfg(arch, ov), mesh)
    try:
        want = {k: v for k, v in jax_layers._SHARD_CTX.items() if k != "mesh"}
        got = {k: v for k, v in layers._SHARD_CTX.items() if k != "mesh"}
        assert got == want and layers._SHARD_CTX["mesh"] is mesh
    finally:
        jax_steps.clear_sharding_hints()
        steps.clear_sharding_hints()
    assert not layers._SHARD_CTX["enabled"]


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("name", list(CASES))
def test_resident_bytes_are_the_planners_blocks(name, port_runs):
    """Each rank holds its params and AdamW moments as the planner's
    blocks, byte for byte (``block_bytes``), less than the whole state."""
    arch, ov, mesh = CASES[name]
    r = port_runs[name]
    shapes = build_model(_port_cfg(arch, ov)).init(0, device="meta")
    whole = 3 * sum(t.numel() * t.element_size()
                    for _, t in _flat_tensors(shapes)) + 4
    assert r["resident"] == r["planned"]
    assert r["resident"] < whole


def test_clip_counts_a_replicated_leaf_once(oracle, port_runs):
    """The clip's global norm over 2x2 blocks counts each leaf once; a
    planted fault that counts every rank's block (a replicated norm four
    times) reads another norm."""
    want = oracle.result()["qwen2-2x2"]["metrics"][0]["grad_norm"]
    np.testing.assert_allclose(
        port_runs["qwen2-2x2"]["metrics"][0]["grad_norm"], want,
        rtol=TRAIN_TOL[0])
    planted = port_runs["double"]["metrics"][0]["grad_norm"]
    assert abs(planted / want - 1) > 100 * TRAIN_TOL[0]


def test_remat_recompute_on_the_backward_thread(oracle, port_runs):
    """Under remat each layer's gathers and its training attention run
    again in the backward; on the card the autograd engine runs it on a
    thread of its own, where no caller's context reaches (the layers'
    shard is entered there again). qwen2 at 2x2, remat on, the backward on
    another thread: the reference's sharded step (remat changes no
    number) within ``TRAIN_TOL``."""
    got, want = port_runs["remat-thread"], oracle.result()["qwen2-2x2"]
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=TRAIN_TOL[0])
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=TRAIN_TOL[0])
    _assert_trees(got["final"], want["final"], lr_sum=2e-3, what="remat")


# ---------------------------------------------------------- checkpoints
def test_elastic_restore_2x1_to_1x2_to_one_device(port_runs):
    """A state saved from 2x1, restored onto 1x2 by ``elastic_restore``
    (every rank's blocks its cut of the saved leaves, bit for bit), saved
    again from there and restored onto one device: the saved leaves,
    bit for bit."""
    saved = port_runs["save-2x1"]["whole"]
    r = port_runs["restore-1x2"]
    assert r["equal"] and r["cut"] > 0 and r["step"] == 1
    _assert_equal_trees(r["whole"], saved, "onto 1x2")
    cfg = _port_cfg("qwen2-0.5b", WIDE)
    target = build_model(cfg).init(1, device="cpu")
    state, step = elastic_restore(Checkpointer(port_runs["dirs"]["b"]),
                                  (target, adamw_init(target)), None)
    assert step == 1
    _assert_equal_trees(state, saved, "onto one device")


def test_jax_checkpoint_restores_onto_a_port_mesh(port_runs, jax_ckpt):
    """A JAX train checkpoint restored onto a 2x2 port mesh: each rank its
    blocks of the JAX leaves, bit for bit."""
    r = port_runs["jax-onto-2x2"]
    assert r["equal"] and r["cut"] > 0
    _assert_equal_trees(r["whole"], jax_ckpt[1], "JAX onto 2x2")


def test_port_mesh_checkpoint_restores_in_jax(port_runs, jax_ckpt):
    """The reverse: a state saved from a 2x2 port mesh (gathered, rank 0
    writing) restores in the JAX ``Checkpointer``, bit for bit."""
    (jp, jopt), step = JaxCheckpointer(port_runs["dirs"]["c"]).restore(
        jax_ckpt[1])
    assert step == 1
    _assert_equal_trees((jp, jopt), port_runs["save-2x2"]["whole"],
                        "2x2 into JAX")


# ------------------------------------------------------------ the launcher
def _launch(tmp_path, d, *extra, **kw):
    return train.main(["--smoke", "--device", "cpu", "--steps", "6",
                       "--batch", "4", "--seq", "32", "--ckpt-every", "2",
                       "--ckpt-dir", str(tmp_path / d), *extra], **kw)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The launcher on one device and over spawned gloo ranks at 2x1."""
    tmp = tmp_path_factory.mktemp("launch")
    return tmp, _launch(tmp, "one"), _launch(tmp, "2x1", "--mesh", "2x1")


def test_launcher_over_a_mesh_matches_one_device(launched, capfd):
    """``--mesh 2x1`` (and 1x2, head-parallel over whole projections):
    the one-device run's losses within 1e-5 relative and its end state
    within ``TRAIN_TOL``; rank 0 prints the reference's lines; each rank
    holds the planner's blocks."""
    tmp, one, mesh = launched
    capfd.readouterr()
    tp = _launch(tmp, "1x2", "--mesh", "1x2")
    out = capfd.readouterr().out
    assert "mesh: data=1, model=2 over gloo on cpu" in out
    assert out.count("done at step 6;") == 1
    for run in (mesh, tp):
        assert run.end == 6 and run.backend == "gloo"
        np.testing.assert_allclose(run.losses, one.losses, rtol=TRAIN_TOL[0])
        _assert_trees(run.state, one.state, lr_sum=6e-3)
        assert all(r["resident"] == r["planned"] for r in run.ranks)


def test_launcher_mesh_replays_and_resumes_elsewhere(launched):
    """Over 2x1: a failure injected on every rank is replayed by every rank
    at the same step and ends on the uninterrupted run's state, bit for
    bit; a preemption at step 3 resumes onto 1x2 and onto one device
    (``elastic_restore``), each to the end, within ``TRAIN_TOL``."""
    tmp, one, mesh = launched
    failed = _launch(tmp, "fail", "--mesh", "2x1",
                     inject_failure=train.FailOnce(3))
    assert failed.metrics.retries == 1 and failed.metrics.restores == 1
    _assert_equal_trees(failed.state, mesh.state, "replayed")
    pre = _launch(tmp, "pre", "--mesh", "2x1", preempt_at=3)
    assert pre.metrics.preempted and pre.end == 3
    shutil.copytree(tmp / "pre", tmp / "pre-one")
    onto = _launch(tmp, "pre", "--mesh", "1x2", "--resume")
    whole = _launch(tmp, "pre-one", "--resume")
    for run in (onto, whole):
        assert run.start == 3 and run.end == 6
        _assert_trees(run.state, mesh.state, what="resumed", lr_sum=6e-3)


def test_a_failure_on_one_rank_ends_every_rank(tmp_path):
    """A step that raises on rank 1 alone, while rank 0 goes on into its
    collectives: the launcher ends every rank and raises rank 1's error;
    nothing waits for the gloo timeout."""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed at step 2"):
        _launch(tmp_path, "fail", "--mesh", "2x1",
                inject_failure=RaiseOnRank(1, 2))
    assert time.monotonic() - t < 120


def test_donated_step_is_the_same_step():
    """``make_train_step(donate=True)`` (the reference launcher's
    ``donate_argnums``: AdamW in place) takes the same steps bit for bit and
    returns the very tensors it was given, written."""
    from repro_torch.data import token_batch

    cfg = _port_cfg("qwen2-0.5b", {})
    model, step = steps.make_train_step(cfg, lr_cfg=LR)
    _, donated = steps.make_train_step(cfg, lr_cfg=LR, donate=True)
    params = model.init(0, device="cpu")
    state = (params, adamw_init(params))
    given = (_clone(params), adamw_init(params))
    for s in range(2):
        b = token_batch(0, s, 0, 2, 32, cfg.vocab_size, device="cpu")
        *state, m = step(*state, b)
        held = [given[0], given[1].m, given[1].v]
        before = [id(t) for t in _leaves_of(held)]
        *given, m2 = donated(*given, b)
        held = [given[0], given[1].m, given[1].v]
        assert [id(t) for t in _leaves_of(held)] == before
        assert float(m["loss"]) == float(m2["loss"])
    _assert_equal_trees(given, state, "donated")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves_of(t)]
    return [tree]
