"""Helpers the port's parity tests share: carrying a JAX params tree across
as numpy, and the hostile smoke weights that make every DFQ rewrite do
real work."""
import numpy as np

import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.core.adversarial import hostile_rescale
from repro.core.tree import set_path
from repro.models import build_model
from repro.quantized.qtensor import QTensor


def jax_to_numpy(tree):
    """The JAX params tree as nested dicts of numpy arrays, each QTensor as
    {"q", "scale", "mode"} (what ``repro_torch.weights.from_jax_numpy``
    takes)."""
    if isinstance(tree, QTensor):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "mode": tree.mode}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def hostile_jax_params(arch="qwen2-0.5b", seed=0):
    """(JAX model, params): the smoke init through ``hostile_rescale`` of
    its MLP pairs, with log-normal norm gains and random qkv / o biases, so
    norm folding, CLE and bias absorption all change the weights."""
    jm = build_model(get_config(arch, smoke=True))
    params = hostile_rescale(jm.init(jax.random.PRNGKey(seed)),
                             jm.dfq_plan(), seed=seed, decades=1.2)
    rng = np.random.RandomState(100 + seed)
    for norm in ("attn_norm", "mlp_norm"):
        shape = np.asarray(params["blocks"][norm]["w"]).shape
        params = set_path(params, ("blocks", norm, "w"), jnp.asarray(
            np.exp(rng.randn(*shape) * 0.5).astype(np.float32)))
    for k in ("bq", "bk", "bv", "bo"):
        shape = np.asarray(params["blocks"]["attn"][k]).shape
        params = set_path(params, ("blocks", "attn", k), jnp.asarray(
            (rng.randn(*shape) * 0.5).astype(np.float32)))
    return jm, params


def serving_pair(variant):
    """((JAX model, params, cfg), (port model, params, cfg), kv_bits) of the
    qwen2 smoke model as the JAX serving tests build it (``PRNGKey(0)``),
    ``variant`` "fp32" or a recipe it goes through ("serve-w8a16",
    "serve-w8a8-kv8"), the weights carried across to the CPU."""
    import repro
    from repro_torch import get_config as torch_get_config
    from repro_torch.models import build_model as torch_build_model
    from repro_torch.weights import from_jax_numpy

    jcfg = get_config("qwen2-0.5b", smoke=True)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if variant != "fp32":
        qm = repro.quantize(jm, params=jp, recipe=variant)
        jm, jp, jcfg = qm.model, qm.params, qm.cfg
    cfg = torch_get_config("qwen2-0.5b-smoke")
    params = from_jax_numpy(jax_to_numpy(jp), cfg, device="cpu")
    kv_bits = 8 if variant.endswith("-kv8") else 16
    return (jm, jp, jcfg), (torch_build_model(cfg), params, cfg), kv_bits


# ----------------------------------------------- parity helpers of the port
#: float32 forwards agree within this fraction of the output's scale
#: (summation order only)
FWD_TOL = 1e-5
#: a bias that a rewrite computed by a sum — bias correction's ε·E[x] (each
#: framework reads E[x] from its own forward), a LayerNorm shift folded
#: through a weight (β·W), a value bias absorbed (bv·wo) — within this
#: fraction of its scale
BIAS_TOL = 1e-5


def close(t, j, tol=FWD_TOL, msg=""):
    """A port tensor (or numpy array) within ``tol`` x max(|j|, 1) of j."""
    import torch

    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=tol * max(np.abs(j).max(), 1.0),
                               err_msg=msg)


def _tuples(x):
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_tuples(v) for v in x)
    return x


def plan_repr(plan):
    """A DFQ plan as plain data (op class names and fields, sites, name),
    comparable across the packages."""
    import dataclasses

    return _tuples(([(type(op).__name__, dataclasses.asdict(op))
                     for op in plan.ops],
                    [dataclasses.asdict(s) for s in plan.sites], plan.name))


def leaves(tree, path=()):
    """(path, leaf) of a params tree in sorted-key order, each QTensor (or
    its ``jax_to_numpy`` dict) as {"q", "scale", "mode"} numpy."""
    from repro_torch.quantized.qtensor import QTensor as PortQTensor

    if isinstance(tree, dict) and set(tree) != {"q", "scale", "mode"}:
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, PortQTensor):
        yield path, {"q": tree.q.numpy(), "scale": tree.scale.numpy(),
                     "mode": tree.mode}
    else:
        yield path, tree


def get_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def summed_biases(plan, corrected_sites=()):
    """The bias paths a plan's rewrites compute by a sum: the consumer
    biases of a LayerNorm fold, the absorbing biases, and the biases of the
    named sites bias correction moved."""
    from repro_torch.core.graph import NormFoldOp, VBiasAbsorbOp

    out = {s.b for s in plan.sites if s.name in corrected_sites}
    for op in plan.ops:
        if isinstance(op, NormFoldOp) and op.norm_b is not None:
            out |= {b for b in op.consumer_biases or () if b is not None}
        elif isinstance(op, VBiasAbsorbOp):
            out.add(op.bo)
    return out


def assert_quantized_equal(tq, jq, summed=()):
    """Every leaf of the port's ``QuantizedModel`` against the reference's:
    packed payloads, scales and modes and the weights bit-equal, the biases
    a rewrite computed by a sum (``summed``, their paths:
    ``summed_biases``) within BIAS_TOL of their scale; the stage records
    equal (SQNR within 1e-4 dB)."""
    jl = dict(leaves(jax_to_numpy(jq.params)))
    tl = dict(leaves(tq.params))
    assert sorted(jl) == sorted(tl)
    for path, t in tl.items():
        j = jl[path]
        if isinstance(t, dict):
            assert t["mode"] == j["mode"], path
            np.testing.assert_array_equal(t["q"], j["q"], err_msg=str(path))
            np.testing.assert_array_equal(t["scale"], j["scale"],
                                          err_msg=str(path))
        elif path in summed:
            close(t, j, tol=BIAS_TOL, msg=str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    assert [r["stage"] for r in tq.report] == [r["stage"] for r in jq.report]
    for rt, rj in zip(tq.report, jq.report):
        mt, mj = dict(rt["metrics"]), dict(rj["metrics"])
        st, sj = mt.pop("sqnr_db", {}), mj.pop("sqnr_db", {})
        for k in ("sqnr_min_db", "sqnr_mean_db"):
            if k in mj:
                assert abs(mt.pop(k) - mj.pop(k)) < 1e-4, k
        assert mt == mj, rt["stage"]
        assert sorted(st) == sorted(sj)
        assert all(abs(st[k] - sj[k]) < 1e-4 for k in st)
