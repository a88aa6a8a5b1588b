"""The port's partition planner (``repro_torch.sharding.partition``) against
the JAX package's (``repro.sharding.partition``), leaf for leaf.

The planner reads only the mesh's axis sizes, so stub meshes 1x2, 2x4 and
2x2x2 (the JAX planner tests' own) stand in for real ones. For the qwen2
smoke config, the widened smoke config (``d_model`` 256, ``head_dim`` 64,
``d_ff`` 512: its attention projections past ``MIN_SHARD_DIM``) and qwen2's
full widths (shapes only, on the meta device), the serve-mode specs of the
fp32 params and of every ``-tp`` recipe's int8 params, and the serving
pool's specs (contiguous and paged, int8 and fp), print as JAX prints them,
path for path. Then the rules the tensor-parallel engine relies on, and
``shard_tree`` cutting a tree to a rank's blocks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import repro
from repro.configs import get_config
from repro.models import build_model
from repro.quantized.qtensor import QTensor as JaxQTensor
from repro.serving import CachePool as JaxCachePool
from repro.sharding import partition as jpart

import repro_torch
from repro_torch.models import build_model as torch_build_model
from repro_torch.quantized.qtensor import QTensor
from repro_torch.serving import CachePool
from repro_torch.sharding import partition as tpart

TP_RECIPES = ["serve-w8a16-tp", "serve-w8a8-tp", "serve-w8a16-kv8-tp",
              "serve-w8a8-kv8-tp"]
WIDE = dict(d_model=256, head_dim=64, d_ff=512)
CONFIGS = ["smoke", "wide", "full"]


class _StubMesh:
    """Just enough mesh for either planner: the axis sizes."""

    def __init__(self, **axes):
        self.shape = dict(axes)

    def __repr__(self):
        return "x".join(str(n) for n in self.shape.values())


MESHES = [_StubMesh(data=1, model=2), _StubMesh(data=2, model=4),
          _StubMesh(pod=2, data=2, model=2)]


def _jax_cfg(which):
    cfg = get_config("qwen2-0.5b", smoke=which != "full")
    return dataclasses.replace(cfg, **WIDE) if which == "wide" else cfg


def _torch_cfg(which):
    cfg = repro_torch.get_config("qwen2-0.5b" + ("" if which == "full"
                                                 else "-smoke"))
    return dataclasses.replace(cfg, **WIDE) if which == "wide" else cfg


_TREES: dict = {}


def _jax_params(which, recipe):
    """JAX params (shape structs at full width) under ``recipe``."""
    key = (which, recipe)
    if key in _TREES:
        return _TREES[key]
    if which != "full":
        jm = build_model(_jax_cfg(which))
        p = jm.init(jax.random.PRNGKey(0))
        if recipe != "fp32":
            p = repro.quantize(jm, params=p, recipe=recipe).params
    else:
        jm = build_model(_jax_cfg("full"))
        p = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        if recipe != "fp32":
            # the smoke artifact says which leaves pack and the scale's
            # shape (per-tensor: [L, 1])
            small = _jax_params("smoke", recipe)
            p = _pack_like(p, small)
    _TREES[key] = p
    return p


def _pack_like(full, small):
    if isinstance(small, JaxQTensor):
        q = jax.ShapeDtypeStruct(full.shape, np.int8)
        n = 1 if small.scale.shape[-1] == 1 else full.shape[-1]
        scale = jax.ShapeDtypeStruct(full.shape[:-2] + (n,), np.float32)
        return JaxQTensor(q, scale, small.mode)
    if isinstance(small, dict):
        return {k: _pack_like(full[k], v) for k, v in small.items()}
    return full


def _meta(tree):
    """A JAX tree's shapes as the port's tree of meta tensors."""
    if isinstance(tree, JaxQTensor):
        return QTensor(torch.empty(tree.q.shape, dtype=torch.int8,
                                   device="meta"),
                       torch.empty(tree.scale.shape, device="meta"),
                       tree.mode)
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


def _jax_specs(spec_tree):
    return {p: str(s) for p, s in jpart.spec_paths(spec_tree)}


def _port_specs(spec_tree):
    return {p: str(s) for p, s in tpart.spec_paths(spec_tree)}


def _heads(which):
    cfg = _jax_cfg(which)
    return {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads}


# ------------------------------------------------------------------ params

@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("recipe", ["fp32"] + TP_RECIPES)
def test_serve_param_specs_equal_jax(recipe, which, mesh):
    jp = _jax_params(which, recipe)
    want = _jax_specs(jpart.params_pspecs(jp, mesh, _heads(which),
                                          mode="serve"))
    got = _port_specs(tpart.params_pspecs(_meta(jp), mesh, _heads(which),
                                          mode="serve"))
    assert got == want


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("mesh", MESHES, ids=repr)
def test_train_and_decode_param_specs_equal_jax(mesh, mode):
    jp = _jax_params("full", "serve-w8a8-tp")
    want = _jax_specs(jpart.params_pspecs(jp, mesh, _heads("full"), mode=mode))
    got = _port_specs(tpart.params_pspecs(_meta(jp), mesh, _heads("full"),
                                          mode=mode))
    assert got == want


def test_payload_scale_pairs_equal_jax():
    jp = _jax_params("full", "serve-w8a16-tp")
    assert tpart.payload_scale_pairs(_meta(jp)) == \
        jpart.payload_scale_pairs(jp)


# ------------------------------------------------------------------- cache

def _pools(which, kv_bits, paged, slots=4):
    kw = dict(page_size=8) if paged else {}
    jcfg, tcfg = _jax_cfg(which), _torch_cfg(which)
    if kv_bits == 8:
        jcfg = dataclasses.replace(jcfg, kv_bias_correct=True)
        tcfg = dataclasses.replace(tcfg, kv_bias_correct=True)
    jpool = JaxCachePool(build_model(jcfg), slots, 32, kv_bits=kv_bits, **kw)
    tpool = CachePool(torch_build_model(tcfg), slots, 32, device="cpu",
                      kv_bits=kv_bits, **kw)
    return jpool.cache, tpool.cache


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("kv_bits", [8, 16])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_serve_cache_specs_equal_jax(paged, kv_bits, which, mesh):
    jc, tc = _pools(which, kv_bits, paged)
    assert sorted(jc) == sorted(tc)
    assert _port_specs(tpart.serve_cache_pspecs(tc, mesh)) == \
        _jax_specs(jpart.serve_cache_pspecs(jc, mesh))


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
def test_non_divisible_slots_and_whole_batch_specs_equal_jax(mesh):
    jc, tc = _pools("smoke", 8, False, slots=3)
    assert _port_specs(tpart.serve_cache_pspecs(tc, mesh)) == \
        _jax_specs(jpart.serve_cache_pspecs(jc, mesh))
    jm = build_model(_jax_cfg("smoke"))
    tm = torch_build_model(_torch_cfg("smoke"))
    for batch in (1, 4):
        jwhole = jm.init_cache(batch, 32, kv_bits=8)
        twhole = tm.init_cache(batch, 32, device="cpu", per_slot=False,
                               kv_bits=8)
        assert _port_specs(tpart.cache_pspecs(twhole, mesh, batch)) == \
            _jax_specs(jpart.cache_pspecs(jwhole, mesh, batch))
        assert str(tpart.batch_pspec(mesh, 2, batch)) == \
            str(jpart.batch_pspec(mesh, 2, batch))


# ------------------------------------------------------------- the rules

def test_column_parallel_scale_co_shards_row_parallel_replicates():
    """wu's int8 payload and per-channel scale share the "model" columns;
    wd shards its in dim and its scale replicates (the reference's
    test_partition rules)."""
    mesh = _StubMesh(data=2, model=4)
    qt = lambda k, n: QTensor(torch.empty((2, k, n), dtype=torch.int8,
                                          device="meta"),
                              torch.empty((2, n), device="meta"), "w8a16")
    spec = tpart.params_pspecs({"blocks": {"mlp": {"wu": qt(256, 512),
                                                   "wd": qt(512, 256)}}},
                               mesh, {"n_q": 8, "n_kv": 2}, mode="serve")
    wu, wd = spec["blocks"]["mlp"]["wu"], spec["blocks"]["mlp"]["wd"]
    assert (wu.q, wu.scale) == (tpart.P(None, None, "model"),
                                tpart.P(None, "model"))
    assert (wd.q, wd.scale) == (tpart.P(None, "model", None),
                                tpart.P(None, None))
    assert str(wu.q) == "PartitionSpec(None, None, 'model')"


class _FakeMesh:
    """A rank's view of a mesh for ``shard_tree``: axis sizes and this
    rank's coordinates."""

    def __init__(self, coords, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self._coords = coords

    def get_local_rank(self, axis):
        return self._coords[axis]


def test_shard_tree_cuts_each_rank_its_block():
    """Rank model=1 of 1x2: column-parallel leaves keep their second half
    of the columns (a QTensor payload's K-major storage a view), the
    row-parallel payload its second half of the rows (copied K-major), the
    vocab-parallel embedding its second half of the rows; replicated
    leaves are the same tensors."""
    cfg = _torch_cfg("wide")
    tq = repro_torch.quantize(torch_build_model(cfg), None,
                              recipe="serve-w8a8-tp", device="cpu")
    mesh = _FakeMesh({"data": 0, "model": 1}, data=1, model=2)
    specs = tpart.params_pspecs(tq.params, mesh,
                                {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads},
                                mode="serve")
    local = tpart.shard_tree(tq.params, specs, mesh)
    full, cut = tq.params["blocks"], local["blocks"]
    assert torch.equal(cut["attn"]["wq"].q, full["attn"]["wq"].q[..., 128:])
    assert cut["attn"]["wq"].q.transpose(-1, -2).is_contiguous()
    assert torch.equal(cut["mlp"]["wd"].q, full["mlp"]["wd"].q[:, 256:, :])
    assert cut["mlp"]["wd"].q.transpose(-1, -2).is_contiguous()
    assert torch.equal(local["embed"], tq.params["embed"][128:])
    assert cut["attn"]["bq"] is full["attn"]["bq"]
