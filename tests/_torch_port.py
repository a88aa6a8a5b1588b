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
