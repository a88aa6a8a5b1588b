"""The JAX package's sharded train step, run as the sharded tests' oracle.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/_jax_sharded_train.py cases.pkl out.pkl

Each case (a dict: ``arch``, ``overrides`` of its smoke config, ``mesh``
(data, model), ``steps``, ``batch``, ``seq``, ``lr``) builds the
reference's model, draws ``init(PRNGKey(0))``, arms
``configure_sharding_hints`` on a ("data", "model") mesh whose axes are
``AxisType.Auto`` (jax 0.9's ``make_mesh`` defaults to ``Explicit`` axes,
which ``with_sharding_constraint`` refuses), places params and AdamW state
by ``params_pspecs`` and runs the jitted ``make_train_step`` on
``token_batch(0, step, 0, batch, seq, vocab)``. The output maps each case's
name to its init params and final (params, AdamWState) as numpy trees, the
per-step loss, grad norm and lr, and ``state_specs`` / ``shardings_for``
as strings. The reference runs unedited; this file only drives it.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys


def _np(tree):
    import jax
    import numpy as np

    return jax.tree.map(lambda a: np.asarray(a), tree)


def _spec_strings(tree, prefix=""):
    from repro.sharding.partition import spec_paths

    return {p: str(s) for p, s in spec_paths(tree, prefix)}


def run_case(case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    from repro.configs import get_config
    from repro.data import token_batch
    from repro.launch import steps
    from repro.models import ShapeConfig
    from repro.optim import adamw_init
    from repro.sharding import batch_pspec, named_shardings, params_pspecs

    cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                              **case.get("overrides", {}))
    d, m = case["mesh"]
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    model, step = steps.make_train_step(cfg, lr_cfg=case["lr"])
    params = model.init(jax.random.PRNGKey(0))
    out = {"init": _np(params)}
    heads = {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads}
    steps.configure_sharding_hints(cfg, mesh)
    try:
        (_, _), (p_spec, o_spec) = steps.state_specs(model, mesh)
        out["state_specs"] = (_spec_strings(p_spec), _spec_strings(o_spec))
        shape = ShapeConfig("t", case["seq"], case["batch"], "train")
        sh = steps.shardings_for(cfg, shape, mesh)
        out["shardings_for"] = {
            k: _spec_strings(jax.tree.map(lambda s: s.spec, sh[k]))
            for k in ("params", "opt")}
        out["shardings_for"]["batch"] = str(sh["batch"].spec)
        p_sh = named_shardings(params_pspecs(params, mesh, heads), mesh)
        opt = adamw_init(params)
        o_sh = named_shardings(steps._opt_spec_tree(None, params_pspecs(
            params, mesh, heads)), mesh)
        params = jax.device_put(params, p_sh)
        opt = jax.device_put(opt, o_sh)
        b_sh = NamedSharding(mesh, batch_pspec(mesh, batch=case["batch"]))
        with jax.set_mesh(mesh):
            jitted = jax.jit(step)
            metrics = []
            for s in range(case["steps"]):
                batch = token_batch(0, s, 0, case["batch"], case["seq"],
                                    cfg.vocab_size)
                batch = jax.device_put(batch, b_sh)
                params, opt, mt = jitted(params, opt, batch)
                metrics.append({k: float(v) for k, v in mt.items()})
    finally:
        steps.clear_sharding_hints()
    out["metrics"] = metrics
    out["final"] = _np((params, opt))
    return out


def main(argv):
    with open(argv[1], "rb") as f:
        cases = pickle.load(f)
    results = {name: run_case(case) for name, case in cases.items()}
    with open(argv[2], "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv)
