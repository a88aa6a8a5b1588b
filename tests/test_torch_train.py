"""The port's LM training path against the JAX package, at smoke size on the
same weights (JAX's init carried across) and the same data (``token_batch``
is bit-equal: tests/test_torch_substrate.py).

Tolerances (float32 throughout; the two packages sum in other orders):

* ``GRAD_TOL``: each leaf of ``value_and_grad`` within 1e-5 of the leaf's
  largest |gradient| plus 1e-7 of the tree's largest (a gradient that is
  zero in exact arithmetic — an attention key bias, which softmax's shift
  invariance cancels — is float32 noise in both packages, ~1e-10, and the
  second term covers it). Measured: at most 3.1e-6 of the leaf's scale
  over the five families.
* ``FWD_TOL`` (``_torch_port``): a forward or a loss within 1e-5 of its
  scale.
* ``BF16_CACHE_TOL``: logits over a bfloat16 KV cache within one bf16
  ulp (2^-8) of their scale: a cached value whose float32 projection
  differs in the last place may round to the neighbouring bf16 value.
* ``TRAIN_TOL``: after AdamW steps, params within 1e-5 of their scale plus
  1e-6 — an update is lr x m̂/(√v̂ + eps), whose rounding the gradients'
  1e-6 differences pass through at up to lr (1e-3) per step — and each
  loss within 1e-5 relative.
"""
import dataclasses
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port import close, jax_to_numpy
from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.data import token_batch as jax_token_batch
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.optim import adamw_init as jax_adamw_init

import torch

from repro_torch import get_config
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import token_batch
from repro_torch.launch import steps, train
from repro_torch.models import LMModel, build_model, layers
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.optim.adamw import _leaves, _map
from repro_torch.weights import from_jax_numpy

GRAD_TOL = (1e-5, 1e-7)
TRAIN_TOL = (1e-5, 1e-6)
FAMILIES = ["qwen2-0.5b", "mixtral-8x22b", "mamba2-2.7b", "zamba2-2.7b",
            "whisper-tiny"]
LR = {"peak_lr": 1e-3, "warmup": 2, "total": 10}
BF16_CACHE_TOL = 2 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file's smoke-size ops, restored after:
    with several test workers on the machine, intra-op threads contend and
    a 20-step launcher run slows ~50x."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _pair(arch, **replace):
    """(JAX model, JAX params, port model, port params) of the smoke
    config, the JAX init (PRNGKey(0)) carried across to the CPU."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(cfg), from_jax_numpy(jax_to_numpy(jp), cfg,
                                                    device="cpu")


def _batch(cfg, B=2, T=32, seed=0):
    """(JAX batch, port batch): random ids, labels, and frames for an
    encoder-decoder."""
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.is_encdec:
        b["frames"] = rng.randn(B, cfg.enc_seq, cfg.d_model).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in b.items()}
    return jb, tb


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


def _port_grads(model, params, batch, **kw):
    """The loss and its gradient per leaf, in sorted-key leaf order."""
    leaf_params = _map(lambda p: p.detach().requires_grad_(), params)
    leaves = _leaves(leaf_params)
    loss = model.loss(leaf_params, batch, **kw)
    return loss, torch.autograd.grad(loss, leaves)


def _assert_grads(grads, jgrads, what):
    want = _flat(jgrads)
    assert len(want) == len(grads), what
    top = max(float(np.abs(a).max()) for _, a in want)
    for (path, a), g in zip(want, grads):
        tol = GRAD_TOL[0] * float(np.abs(a).max()) + GRAD_TOL[1] * top
        np.testing.assert_allclose(g.numpy(), a, rtol=0, atol=tol,
                                   err_msg=f"{what}: {'/'.join(map(str, path))}")


def _assert_trees(t_tree, j_tree, tol=TRAIN_TOL, what="", lr_sum=0.0):
    """Every leaf within ``tol``; a key bias param (path ending "bk" under
    the train state's params) within 2 x ``lr_sum`` instead: its gradient
    is zero in exact arithmetic (softmax's shift invariance), so each
    package's Adam step on its float32 noise is of size lr, in a direction
    no computation pins."""
    tl, jl = _flat(t_tree), _flat(j_tree)
    assert [p for p, _ in tl] == [p for p, _ in jl], what
    for (path, t), (_, j) in zip(tl, jl):
        atol = tol[0] * float(np.abs(j).max()) + tol[1]
        if lr_sum and path[0] == 0 and path[-1] == "bk":
            atol = 2 * lr_sum
        np.testing.assert_allclose(
            t.astype(np.float64), j.astype(np.float64), rtol=0, atol=atol,
            err_msg=f"{what}: {'/'.join(map(str, path))}")


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", FAMILIES)
def test_value_and_grad_matches_jax(arch):
    """The loss and its gradient per leaf, through the float32 smoke
    forward of each family (the MoE router's stable top-k, the SSD's
    logaddexp softplus, the gold logit by gather against JAX's masked
    sum)."""
    jm, jp, tm, tp = _pair(arch)
    jb, tb = _batch(tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb)))(jp)
    tl, grads = _port_grads(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    close(tl, jl, msg=arch)
    _assert_grads(grads, jg, arch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_remat_changes_no_number(arch):
    """``cfg.remat`` recomputes each block in the backward: the loss and
    every gradient are those of the run without it, bit for bit."""
    _, _, _, tp = _pair(arch)
    cfg = get_config(arch, smoke=True)
    _, tb = _batch(cfg)
    out = {}
    for remat in (False, True):
        out[remat] = _port_grads(build_model(dataclasses.replace(
            cfg, remat=remat)), tp, tb)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_bf16_forward_gives_float32_grads():
    """A bf16 compute dtype over float32 params: the casts' gradients come
    back float32, one per param, all finite."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              dtype="bfloat16", remat=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    _, tb = _batch(cfg)
    loss, grads = _port_grads(model, params, tb)
    assert np.isfinite(float(loss.detach()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


# ----------------------------------------------------- chunked attention
@pytest.mark.parametrize("T,chunk_kv,chunk_q,segments,window", [
    (64, 16, 8, 4, None),      # causal frontier per segment
    (64, 16, 16, 2, 24),       # a sliding window's mask
    (64, 8, None, 8, None),    # the default chunk_q: all of Tq, 1 segment
    (48, 16, 12, 1, None),     # no segments
])
def test_chunked_attention_matches_jax(T, chunk_kv, chunk_q, segments,
                                       window):
    """The two-level online softmax against the reference's, output and
    gradients of q, k and v."""
    rng = np.random.RandomState(T + chunk_kv)
    q, k, v = (rng.randn(2, T, 3, 8).astype(np.float32) for _ in range(3))
    w = rng.randn(2, T, 3, 8).astype(np.float32)
    mask = np.tril(np.ones((T, T), bool))
    if window is not None:
        mask &= ~np.tril(np.ones((T, T), bool), -window)

    def jf(q, k, v):
        out = jax_layers.attention_scores_softmax(
            q, k, v, jnp.asarray(mask), chunk_kv=chunk_kv, chunk_q=chunk_q,
            causal_segments=segments)
        return jnp.sum(out * w), out

    (_, jo), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                             has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = layers.attention_scores_softmax(
        tq, tk, tv, torch.from_numpy(mask), chunk_kv=chunk_kv,
        chunk_q=chunk_q, causal_segments=segments)
    close(to, jo)
    tg = torch.autograd.grad((to * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for a, b in zip(tg, jg):
        close(a, b)
    # the chunked path computes the unchunked softmax
    with torch.no_grad():
        close(to, layers.attention_scores_softmax(
            tq, tk, tv, torch.from_numpy(mask)).numpy())


def test_chunked_attention_refuses_what_the_reference_refuses():
    q = torch.zeros(2, 32, 2, 4)
    with pytest.raises(NotImplementedError, match="per-slot"):
        layers.attention_scores_softmax(q, q, q, torch.ones(2, 32, 32,
                                                            dtype=torch.bool),
                                        chunk_kv=8)
    with pytest.raises(ValueError, match="does not divide"):
        layers.attention_scores_softmax(q, q, q, None, chunk_kv=12)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b",
                                  "whisper-tiny"])
def test_chunked_loss_matches_jax(arch):
    """``loss(..., chunk_kv=16)`` over 64 positions (mixtral's 16-position
    window masks inside the chunks): value and gradients against the
    reference's, and the value against the unchunked loss."""
    jm, jp, tm, tp = _pair(arch)
    jb, tb = _batch(tm.cfg, T=64)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, chunk_kv=16)))(jp)
    tl, grads = _port_grads(tm, tp, tb, chunk_kv=16)
    close(tl, jl, msg=arch)
    _assert_grads(grads, jg, arch)
    with torch.no_grad():
        close(tl, tm.loss(tp, tb), msg=arch)


def test_prefill_and_decode_steps_match_jax():
    """``make_prefill_step`` (a whole-batch bf16 cache; ``chunk_kv``
    chunks the attention over it) and ``make_decode_step`` against the
    reference's, on the float32 smoke config."""
    jcfg = jax_get_config("qwen2-0.5b", smoke=True)
    cfg = get_config("qwen2-0.5b", smoke=True)
    shape = jax_steps.ShapeConfig("tiny", 32, 2, "prefill")
    jm, jpre = jax_steps.make_prefill_step(jcfg, shape, chunk_kv=16)
    _, jdec = jax_steps.make_decode_step(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")
    _, tpre = steps.make_prefill_step(cfg, shape, chunk_kv=16)
    _, tdec = steps.make_decode_step(cfg)
    toks = np.random.RandomState(3).randint(0, 256, (2, 32)).astype(np.int32)
    jl, jc = jpre(jp, jnp.asarray(toks))
    tl, tc = tpre(tp, torch.from_numpy(toks).long())
    assert tc["k"].dtype == torch.bfloat16 and tc["pos"].ndim == 0
    # the bf16 cache rounds k and v: where the float32 projections differ
    # in the last place, a cached value may round one bf16 ulp (2^-8) apart
    close(tl, jl, tol=BF16_CACHE_TOL)
    nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    close(tdec(tp, tc, torch.from_numpy(nxt).long())[0],
          jdec(jp, jc, jnp.asarray(nxt))[0], tol=BF16_CACHE_TOL)


# ---------------------------------------------------- the prepare repair
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny"])
def test_prepare_under_autograd_builds_a_fresh_graph(arch):
    """Two backwards over ONE params object whose leaves require grad (a
    replayed step) each run through their own graph, and an in-place
    update between them is read; with no leaf requiring grad (serving) the
    casts are built once per tree."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    _, tb = _batch(cfg)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    g1 = torch.autograd.grad(model.loss(params, tb), leaves)
    g2 = torch.autograd.grad(model.loss(params, tb), leaves)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    with torch.no_grad():
        for p in leaves:
            p.mul_(1.5)
    g3 = torch.autograd.grad(model.loss(params, tb), leaves)
    assert any(not torch.equal(a, b) for a, b in zip(g1, g3))
    assert model._prepared is None
    for p in leaves:
        p.requires_grad_(False)
    first = model.prepare(params)
    assert model.prepare(params)[0] is first[0]


# --------------------------------------------------------- training steps
def test_five_train_steps_match_jax():
    """``make_train_step``'s step, five times over the same token batches,
    against the reference's jitted step: losses, gradient norms,
    learning rates (bit-equal: ``cosine_schedule``), params and moments."""
    jcfg = jax_get_config("qwen2-0.5b", smoke=True)
    cfg = get_config("qwen2-0.5b", smoke=True)
    jm, jstep = jax_steps.make_train_step(jcfg, lr_cfg=LR)
    jstep = jax.jit(jstep)
    _, tstep = steps.make_train_step(cfg, lr_cfg=LR)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    lr_sum = 0.0
    for s in range(5):
        jb = jax_token_batch(0, s, 0, 4, 32, cfg.vocab_size)
        tb = token_batch(0, s, 0, 4, 32, cfg.vocab_size, device="cpu")
        jp, jopt, jm_ = jstep(jp, jopt, jb)
        tp, topt, tm_ = tstep(tp, topt, tb)
        assert all(not p.requires_grad for p in _leaves(tp))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=TRAIN_TOL[0])
        np.testing.assert_allclose(float(tm_["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-5)
        # the reference's jitted step may contract the schedule's
        # multiply-add (an ulp); the function itself is bit-equal
        np.testing.assert_allclose(float(tm_["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
        lr_sum += float(tm_["lr"])
    assert int(topt.step) == int(jopt.step) == 5
    _assert_trees((tp, topt), (jp, jopt), what="after 5 steps",
                  lr_sum=lr_sum)


def test_launcher_losses_match_jax(tmp_path, monkeypatch, capsys):
    """``repro_torch.launch.train --smoke --device cpu --steps 20`` against
    ``repro.launch.train --smoke --steps 20`` (the reference's flags and
    data; the port's init replaced by the JAX init): every step's loss
    within 1e-5 relative, and the reference's printed lines.

    The reference launcher's three sharding calls are replaced by no-ops
    here: under jax 0.9 its one-device mesh refuses the embedding gather
    of the sharded params (``ShardingTypeError``) before the first step.
    Its model, step, data, checkpointer and loop run as written."""
    import repro.launch.train as jtrain

    jlosses = []

    class Recording(jtrain.FaultTolerantLoop):
        def __init__(self, step_fn, *a, **kw):
            def rec(state, batch):
                state, m = step_fn(state, batch)
                jlosses.append(m["loss"])
                return state, m
            super().__init__(rec, *a, **kw)

    monkeypatch.setattr(jtrain, "FaultTolerantLoop", Recording)
    monkeypatch.setattr(jtrain, "configure_sharding_hints",
                        lambda *a, **kw: None)
    monkeypatch.setattr(jtrain, "params_pspecs", lambda *a, **kw: None)
    monkeypatch.setattr(jtrain, "named_shardings", lambda *a, **kw: None)
    monkeypatch.setattr(sys, "argv", [
        "train", "--smoke", "--steps", "20", "--ckpt-dir",
        str(tmp_path / "jax")])
    jtrain.main()
    jp = jax_build_model(jax_get_config("qwen2-0.5b", smoke=True)).init(
        jax.random.PRNGKey(0))
    carried = jax_to_numpy(jp)
    monkeypatch.setattr(LMModel, "init", lambda self, seed=0, device="cuda":
                        from_jax_numpy(carried, self.cfg, device=device))
    capsys.readouterr()
    run = train.main(["--smoke", "--device", "cpu", "--steps", "20",
                      "--ckpt-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert "step 10: loss" in out and "step 20: loss" in out
    assert "done at step 20;" in out and "retries: 0" in out
    assert run.end == 20 and len(run.losses) == len(jlosses) == 20
    np.testing.assert_allclose(run.losses, jlosses, rtol=TRAIN_TOL[0])
    assert np.mean(run.losses[-5:]) < np.mean(run.losses[:5])
    assert Checkpointer(str(tmp_path / "port")).latest_step() == 20


def test_launcher_replays_and_resumes_to_the_same_state(tmp_path):
    """The fault path on the CPU: a failure injected past the first
    checkpoint (restore, replay) and a preemption then ``--resume`` in a
    fresh loop both end on the uninterrupted run's state, bit for bit; the
    preemption checkpoint is the state the loop held."""
    def args(d, *extra):
        return ["--smoke", "--device", "cpu", "--steps", "6", "--batch",
                "2", "--seq", "32", "--ckpt-dir", str(tmp_path / d),
                "--ckpt-every", "2", *extra]

    ref = train.main(args("ref"))
    fired = []
    failed = train.main(args("fail"), inject_failure=lambda s: (
        s == 5 and not fired and not fired.append(s)))
    assert failed.metrics.retries == 1 and failed.metrics.restores == 1
    # restored from step 4, or from step 2 while step 4's save was written
    assert len(failed.losses) in (7, 9)
    pre = train.main(args("pre"), preempt_at=5)
    assert pre.metrics.preempted and pre.end == 5
    saved, step = Checkpointer(str(tmp_path / "pre")).restore(pre.state)
    assert step == 5 and isinstance(saved[1], AdamWState)
    _assert_trees(saved, pre.state, tol=(0, 0), what="preemption checkpoint")
    resumed = train.main(args("pre", "--resume"))
    assert resumed.start == 5 and resumed.end == 6
    for run in (failed, resumed):
        _assert_trees(run.state, ref.state, tol=(0, 0), what="end state")


def test_donated_launcher_is_todays_launcher(tmp_path, monkeypatch):
    """The launcher donates its state to the step (the reference's
    ``donate_argnums=(0, 1)``; AdamW in place): every loss, the end state
    and every checkpoint (written asynchronously while the next step
    updates the state in place) equal a run whose step does not donate,
    bit for bit."""
    def args(d):
        return ["--smoke", "--device", "cpu", "--steps", "6", "--batch",
                "2", "--seq", "32", "--ckpt-dir", str(tmp_path / d),
                "--ckpt-every", "2"]

    donated = train.main(args("donated"))
    real = train.make_train_step
    monkeypatch.setattr(train, "make_train_step", lambda cfg, **kw: real(
        cfg, **{**kw, "donate": False}))
    kept = train.main(args("kept"))
    assert donated.losses == kept.losses
    _assert_trees(donated.state, kept.state, tol=(0, 0), what="end state")
    for step in (4, 6):
        a, _ = Checkpointer(str(tmp_path / "donated")).restore(
            donated.state, step=step)
        b, _ = Checkpointer(str(tmp_path / "kept")).restore(kept.state,
                                                            step=step)
        _assert_trees(a, b, tol=(0, 0), what=f"checkpoint {step}")


# the fault-tolerant loop over donated steps, in both packages: the JAX
# step jitted with donate_argnums=(0, 1) (its buffers deleted by the
# call), the port's make_train_step(donate=True)
DONATED_STEPS = 5


def _donated_runs(tmp_path, scenario, ckpt_every):
    """Each package's ``FaultTolerantLoop`` over donated steps of smoke
    qwen2 from the JAX init, one fault at step 2: ``inject`` (the loop's
    hook, before the step), ``after_update`` (raised inside the step once
    the in-place update is done) or ``nan`` (a non-finite loss reported
    after the update). Returns {package: (state or None, metrics, the
    error raised or None)}."""
    from repro.runtime import FaultTolerantLoop as JaxLoop
    from repro_torch.runtime import FaultTolerantLoop

    jm, jstep = jax_steps.make_train_step(
        jax_get_config("qwen2-0.5b", smoke=True), lr_cfg=LR)
    cfg = get_config("qwen2-0.5b-smoke")
    _, tstep = steps.make_train_step(cfg, lr_cfg=LR, donate=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")
    jitted = jax.jit(jstep, donate_argnums=(0, 1))
    runs = {}
    for pkg in ("jax", "port"):
        fired = []

        def fault(s):
            if s == 2 and not fired:
                fired.append(s)
                return True
            return False

        def step_fn(state, batch, pkg=pkg):
            params, opt, m = (jitted if pkg == "jax" else tstep)(*state,
                                                                  batch)
            loss = float(m["loss"])
            done = int(opt.step) - 1          # the step just taken
            if scenario == "after_update" and fault(done):
                raise RuntimeError("a failure after the in-place update")
            if scenario == "nan" and fault(done):
                loss = float("nan")
            return (params, opt), {"loss": loss}

        if pkg == "jax":
            loop = JaxLoop(step_fn, lambda s: jax_token_batch(
                0, s, 0, 2, 32, cfg.vocab_size),
                JaxCheckpointer(str(tmp_path / pkg)), ckpt_every=ckpt_every)
            state = (jp, jax_adamw_init(jp))
        else:
            loop = FaultTolerantLoop(step_fn, lambda s: token_batch(
                0, s, 0, 2, 32, cfg.vocab_size, device="cpu"),
                Checkpointer(str(tmp_path / pkg)), ckpt_every=ckpt_every)
            state = (tp, adamw_init(tp))
        try:
            state, _ = loop.run(state, 0, DONATED_STEPS,
                                inject_failure=(fault if scenario == "inject"
                                                else None))
            runs[pkg] = (state, loop.metrics, None)
        except Exception as e:  # noqa: BLE001 - the outcome under test
            runs[pkg] = (None, loop.metrics, e)
    return runs


@pytest.fixture(scope="module")
def donated_uninterrupted(tmp_path_factory):
    return _donated_runs(tmp_path_factory.mktemp("donated"), None, 100)


@pytest.mark.parametrize("scenario,ckpt_every,outcome", [
    ("inject", 100, "uninterrupted"),
    ("after_update", 100, "raises"),
    ("after_update", 1, "uninterrupted"),
    ("nan", 100, "stepped twice"),
])
def test_retry_on_donated_state_follows_the_reference(
        scenario, ckpt_every, outcome, tmp_path, donated_uninterrupted):
    """``FaultTolerantLoop``'s retry over donated state, held to the
    reference's loop over its jitted, donating step:

    * a failure injected before the first save: no checkpoint, the retry
      runs on the state as the loop holds it (untouched) — both end on
      the uninterrupted run's state;
    * a failure inside the step after the in-place update began: the
      state the loop holds was given away (JAX: its buffers deleted; the
      port: the step refuses the params it last took), so with no
      checkpoint every retry fails and the loop raises after its retries
      in both; with one, both restore and end on the uninterrupted state;
    * a non-finite loss under ``abort_on_nan``: the update is kept (the
      loop took the step's state before the check), the retry runs the
      step again on it — both end on that state, not the uninterrupted
      one.

    The port against the reference within ``TRAIN_TOL``; the port against
    its own uninterrupted run bit for bit where both replay to it."""
    runs = _donated_runs(tmp_path, scenario, ckpt_every)
    (jstate, jm, jerr), (tstate, tm, terr) = runs["jax"], runs["port"]
    assert (jm.retries, jm.restores) == (tm.retries, tm.restores)
    if outcome == "raises":
        msg = str(jerr).lower()
        assert jerr is not None and ("deleted" in msg
                                     or "invalid buffer" in msg)
        assert isinstance(terr, RuntimeError) and "donated" in str(terr)
        assert tm.retries == 3
        return
    assert jerr is None and terr is None, (jerr, terr)
    _assert_trees(tstate, jstate, what=scenario, lr_sum=5e-3)
    ref = donated_uninterrupted["port"][0]
    if outcome == "uninterrupted":
        _assert_trees(tstate, ref, tol=(0, 0), what=scenario)
    else:
        moved = max(float((a - b).abs().max()) for a, b in zip(
            _leaves(tstate[0]), _leaves(ref[0])))
        assert moved > 1e-5


def test_launcher_runs_on_the_card_unless_told_otherwise(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


# ------------------------------------------- checkpoints across packages
def test_jax_train_checkpoint_restores_in_the_port(tmp_path):
    """A JAX-written ``(params, AdamWState)`` after two steps restores into
    the port's train state leaf for leaf, bit for bit, its NamedTuple type
    rebuilt; one more step on each side agrees."""
    jcfg, cfg = (jax_get_config("qwen2-0.5b", smoke=True),
                 get_config("qwen2-0.5b", smoke=True))
    jm, jstep = jax_steps.make_train_step(jcfg, lr_cfg=LR)
    jstep = jax.jit(jstep)
    _, tstep = steps.make_train_step(cfg, lr_cfg=LR)
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = jax_adamw_init(jp)
    for s in range(2):
        jp, jopt, _ = jstep(jp, jopt, jax_token_batch(0, s, 0, 2, 32, 256))
    JaxCheckpointer(str(tmp_path)).save(2, (jp, jopt), blocking=True)
    target = build_model(cfg).init(1, device="cpu")
    (tp, topt), step = Checkpointer(str(tmp_path)).restore(
        (target, adamw_init(target)))
    assert step == 2 and isinstance(topt, AdamWState)
    assert topt.step.dtype == torch.int32 and int(topt.step) == 2
    _assert_trees((tp, topt), (jp, jopt), tol=(0, 0), what="restored")
    jp, jopt, _ = jstep(jp, jopt, jax_token_batch(0, 2, 0, 2, 32, 256))
    tp, topt, m = tstep(tp, topt, token_batch(0, 2, 0, 2, 32, 256,
                                              device="cpu"))
    _assert_trees((tp, topt), (jp, jopt), what="continued",
                  lr_sum=float(m["lr"]))


def test_port_train_checkpoint_restores_in_jax(tmp_path):
    """The reverse: the port's train state after two steps, restored by
    the JAX checkpointer into a JAX ``(params, AdamWState)``, bit for bit;
    one more step on each side agrees."""
    jcfg, cfg = (jax_get_config("qwen2-0.5b", smoke=True),
                 get_config("qwen2-0.5b", smoke=True))
    jm, jstep = jax_steps.make_train_step(jcfg, lr_cfg=LR)
    _, tstep = steps.make_train_step(cfg, lr_cfg=LR)
    jp0 = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax_to_numpy(jp0), cfg, device="cpu")
    topt = adamw_init(tp)
    for s in range(2):
        tp, topt, _ = tstep(tp, topt, token_batch(0, s, 0, 2, 32, 256,
                                                  device="cpu"))
    Checkpointer(str(tmp_path)).save(2, (tp, topt), blocking=True)
    (jp, jopt), step = JaxCheckpointer(str(tmp_path)).restore(
        (jp0, jax_adamw_init(jp0)))
    assert step == 2 and type(jopt).__name__ == "AdamWState"
    _assert_trees((tp, topt), (jp, jopt), tol=(0, 0), what="restored")
    jp, jopt, _ = jax.jit(jstep)(jp, jopt,
                                 jax_token_batch(0, 2, 0, 2, 32, 256))
    tp, topt, m = tstep(tp, topt, token_batch(0, 2, 0, 2, 32, 256,
                                              device="cpu"))
    _assert_trees((tp, topt), (jp, jopt), what="continued",
                  lr_sum=float(m["lr"]))
