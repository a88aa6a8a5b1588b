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
