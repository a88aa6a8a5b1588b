"""The port's AdamW (``repro_torch.optim``) against ``repro.optim.adamw``.

The same numpy parameters and gradients, a tree of dicts and lists with
leaves of 1 to 4 dimensions, go through three steps of each package's
``adamw_update``: the second step's gradients are scaled past the clip
norm. Elementwise the update is the JAX one's arithmetic; only the global
norm (a float32 sum over every leaf, in another order) and the float32
``b ** step`` of the bias corrections may round otherwise. So the norm is
held within 1e-6 relative, the moments within 2e-6 relative and the
parameters within 1e-6 of their magnitude plus 1e-9 (lr 3e-3 times a few
ulp of the unit-size Adam step).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.optim import adamw as jadamw

from repro_torch.optim import AdamWState, adamw_init, adamw_update, global_norm


def _tree(rng, scale=1.0):
    return {"conv": {"w": (rng.randn(3, 3, 2, 4) * scale).astype(np.float32),
                     "bn": {"gamma": (rng.randn(4) * scale).astype(np.float32)}},
            "blocks": [{"w": (rng.randn(4, 5) * scale).astype(np.float32),
                        "b": (rng.randn(5) * scale).astype(np.float32)},
                       {"w": (rng.randn(5, 3) * scale).astype(np.float32)}]}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(t_tree, j_tree):
    jl = jax.tree.leaves(j_tree)
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), t_tree,
                                      is_leaf=torch.is_tensor))
    assert len(jl) == len(tl)
    return zip(tl, jl)


@pytest.mark.parametrize("weight_decay,clip_norm", [(1e-4, 1.0), (0.1, 5.0)])
def test_three_steps_one_clipped_match_jax(weight_decay, clip_norm):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    clipped = []
    for step, gscale in enumerate((0.01, 100.0, 0.03)):
        grads = _tree(np.random.RandomState(10 + step), gscale)
        jp, js, jgn = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, grads), js, jp, lr=3e-3,
            weight_decay=weight_decay, clip_norm=clip_norm)
        tp, ts, tgn = adamw_update(_to_torch(grads), ts, tp, lr=3e-3,
                                   weight_decay=weight_decay,
                                   clip_norm=clip_norm)
        clipped.append(float(jgn) > clip_norm)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for mom in ("m", "v"):
            for t, j in _pairs(getattr(ts, mom), _np(getattr(js, mom))):
                np.testing.assert_allclose(t, j, rtol=2e-6, atol=1e-30)
        for t, j in _pairs(tp, _np(jp)):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-9)
    assert clipped == [False, True, False]


def test_decay_only_where_ndim_at_least_2():
    """With zero gradients the Adam step is 0: 2-D and 4-D leaves shrink by
    lr · decay, 1-D leaves (norms, biases) stay as they were."""
    params = _to_torch(_tree(np.random.RandomState(1)))
    zeros = jax.tree.map(torch.zeros_like, params, is_leaf=torch.is_tensor)
    new, _, gn = adamw_update(zeros, adamw_init(params), params, lr=0.5,
                              weight_decay=0.1)
    assert float(gn) == 0.0
    for t, p in _pairs(new, jax.tree.map(lambda x: x.numpy(), params,
                                         is_leaf=torch.is_tensor)):
        if p.ndim >= 2:
            np.testing.assert_allclose(t, p * np.float32(1 - 0.05), rtol=1e-6)
        else:
            np.testing.assert_array_equal(t, p)


def test_init_and_global_norm():
    params = _to_torch(_tree(np.random.RandomState(2)))
    st = adamw_init(params)
    assert isinstance(st, AdamWState) and int(st.step) == 0
    assert st.step.dtype == torch.int32
    for m in jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), st.m,
                                          is_leaf=torch.is_tensor)):
        assert m.dtype == np.float32 and not m.any()
    want = np.sqrt(sum(float(np.sum(np.square(a, dtype=np.float64)))
                       for a in jax.tree.leaves(_tree(np.random.RandomState(2)))))
    np.testing.assert_allclose(float(global_norm(params)), want, rtol=1e-6)
