"""Divisibility-aware partition planner (port of ``repro.sharding.partition``).

Pure Python over shapes: each parameter (or cache) leaf gets a
``PartitionSpec`` over the serving mesh (("pod",) "data", "model") by the
reference's rules, leaf for leaf:

  * **TP** ("model") Megatron-style: column-parallel q/k/v/gate/up on
    their out dims, row-parallel o/down on their in dims, attention
    projections only where the head count divides the model axis,
  * **FSDP** ("data") on the in dim in train mode; serve (and decode) mode
    drops it, the weights stay resident,
  * a per-channel QTensor scale co-shards with its payload's columns in
    serve mode; row-parallel and per-tensor scales replicate,
  * embeddings vocab-parallel (vocab on "model"),
  * anything non-divisible, or under ``MIN_SHARD_DIM``, replicates.

A spec is a tuple of axis names (or a tuple of them, or None) whose
``str`` is the JAX one (``PartitionSpec(None, 'model')``), so an artifact
records specs either package reads. The planner reads only the mesh's axis
sizes: a ``torch.distributed`` ``DeviceMesh`` or any object whose
``shape`` maps axis → size (the tests' stub meshes). ``shard_tree`` takes
the place of the reference's ``named_shardings``: it cuts every leaf to this
rank's block of a real mesh. The training side: ``opt_spec_tree`` (the
AdamW state's specs, the reference's ``_opt_spec_tree``), ``block_bytes``
(what a rank holds of a tree under its specs) and ``named_shardings``
(a spec tree bound to its mesh, what ``Checkpointer.restore(shardings=)``
reads).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

from ..quantized.qtensor import QTensor, k_major

MIN_SHARD_DIM = 128  # don't shard tiny dims — collective overhead dominates

_ROW_PARALLEL = ("wo", "wd", "out_proj")   # consume a TP-sharded activation


class PartitionSpec(tuple):
    """A tuple of per-dim placements: None (replicated), an axis name, or a
    tuple of axis names; printed as JAX prints its ``PartitionSpec``."""

    def __new__(cls, *axes):
        # a one-axis tuple is that axis, as JAX normalizes it
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


class QTensorSpec(NamedTuple):
    """A QTensor's place in a spec tree: its payload's and scale's specs."""
    q: P
    scale: P
    mode: str


def mesh_sizes(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh`` or of a stub with a dict ``shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _divisible(dim: int, size: int) -> bool:
    return dim >= MIN_SHARD_DIM and dim % size == 0


def _leaf_spec(path: str, shape, mesh, n_stacked: int,
               heads: Optional[dict] = None, mode: str = "train") -> P:
    """The reference's Megatron placement of one leaf (see the module
    docstring): ``mode="decode"`` drops the FSDP factor, ``mode="serve"``
    also co-shards a column-parallel QTensor's scale with its payload."""
    axes: list = [None] * len(shape)
    if len(shape) == 0:
        return P()
    sizes = mesh_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)
    if mode in ("decode", "serve"):
        data_n = 10 ** 9  # nothing divides this → no FSDP factor on weights
    heads = heads or {}
    n_q, n_kv = heads.get("n_q", 0), heads.get("n_kv", 0)

    def head_ok(n):
        return n > 0 and n % model_n == 0

    is_attn = "/attn/" in path or "/cross/" in path
    name = path.rsplit("/", 1)[-1]
    if name in ("q", "scale"):           # QTensor children: the rules key
        parent = path.rsplit("/", 3)[-2]  # off the parent weight's name
        if name == "scale":
            if mode != "serve":
                return P()
            out = len(shape) - 1
            tp_ok = _divisible(shape[out], model_n) and parent not in _ROW_PARALLEL
            if is_attn and parent == "wq":
                tp_ok = tp_ok and head_ok(n_q)
            elif is_attn and parent in ("wk", "wv"):
                tp_ok = tp_ok and head_ok(n_kv)
            elif parent == "in_proj":
                tp_ok = False
            if tp_ok:
                axes[out] = "model"
            return P(*axes)
        name = parent

    is_embed = (path.endswith("embed") or path.endswith("lm_head")
                or path.endswith("dec_pos"))
    if is_embed and len(shape) == 2:
        spec = [None, None]
        if _divisible(shape[0], model_n):
            spec[0] = "model"          # vocab-parallel
        if _divisible(shape[1], data_n):
            spec[1] = "data"
        if path.endswith("lm_head"):   # [D, V]: vocab is the LAST dim
            spec = [None, None]
            if _divisible(shape[1], model_n):
                spec[1] = "model"
            if _divisible(shape[0], data_n):
                spec[0] = "data"
        return P(*spec)

    free = list(range(n_stacked, len(shape)))
    if len(free) < 2:
        return P()  # 1-D (biases, norm scales): replicate

    in_dim, out_dim = free[-2], free[-1]
    if name in _ROW_PARALLEL:
        tp_ok = _divisible(shape[in_dim], model_n)
        if name == "wo":
            tp_ok = tp_ok and head_ok(n_q)
        if tp_ok:
            axes[in_dim] = "model"
        if _divisible(shape[out_dim], data_n):
            axes[out_dim] = "data"
        return P(*axes)

    # column-parallel default
    tp_ok = _divisible(shape[out_dim], model_n)
    if is_attn and name == "wq":
        tp_ok = tp_ok and head_ok(n_q)
    elif is_attn and name in ("wk", "wv"):
        tp_ok = tp_ok and head_ok(n_kv)
    elif name == "in_proj":
        tp_ok = False  # mamba: mixed z/x/B/C/dt segments — replicate out
    if tp_ok:
        axes[out_dim] = "model"
    if _divisible(shape[in_dim], data_n):
        axes[in_dim] = "data"
    return P(*axes)


def _n_stacked(path: str) -> int:
    n = 0
    if "blocks" in path:  # scan-stacked layers (and shared_blocks)
        n += 1
    if "experts" in path:
        n += 1
    return n


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    elif isinstance(tree, QTensor):  # int8 serving weights: q + scale
        yield from _walk(tree.q, f"{prefix}/q")
        yield from _walk(tree.scale, f"{prefix}/scale")
    else:
        yield prefix, tree


def _rebuild(tree, flat: dict, prefix: str = ""):
    """Re-nest a {path: spec} mapping into ``tree``'s structure (the
    inverse of ``_walk``; a QTensor becomes a ``QTensorSpec``)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        kids = [_rebuild(v, flat, f"{prefix}/{i}") for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(
            kids)
    if isinstance(tree, QTensor):
        return QTensorSpec(_rebuild(tree.q, flat, f"{prefix}/q"),
                           _rebuild(tree.scale, flat, f"{prefix}/scale"),
                           tree.mode)
    return flat[prefix]


def _dp_world(mesh):
    """(dp_axes, dp_n): the data-parallel axis spec (with the leading "pod"
    when present) and its total world size."""
    sizes = mesh_sizes(mesh)
    dp_axes = ("pod", "data") if "pod" in sizes else "data"
    dp_n = 1
    for a in ((dp_axes,) if isinstance(dp_axes, str) else dp_axes):
        dp_n *= sizes[a]
    return dp_axes, dp_n


def params_pspecs(params_shapes: Any, mesh, heads: Optional[dict] = None,
                  mode: str = "train") -> Any:
    """PartitionSpec tree matching a params tree (of tensors, or of anything
    with a ``shape``). ``heads`` = {"n_q", "n_kv"} enables the
    head-divisibility rule of the attention projections."""
    paths = dict(_walk(params_shapes))
    flat = {p: _leaf_spec(p, tuple(leaf.shape), mesh, _n_stacked(p), heads,
                          mode)
            for p, leaf in paths.items()}
    return _rebuild(params_shapes, flat)


def replicated_pspecs(tree: Any) -> Any:
    """A spec tree that replicates every leaf of ``tree``."""
    return _rebuild(tree, {p: P() for p, _ in _walk(tree)})


def batch_pspec(mesh, ndim: int = 2, batch: Optional[int] = None) -> P:
    """Batch dim over (pod, data); replicate when the global batch doesn't
    divide the DP world."""
    sizes = mesh_sizes(mesh)
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    dp_n = 1
    for a in dp:
        dp_n *= sizes[a]
    if batch is not None and batch % dp_n != 0:
        return P(*([None] * ndim))
    return P(dp, *([None] * (ndim - 1)))


def cache_pspecs(cache_shapes: Any, mesh, batch: int) -> Any:
    """The whole-batch KV/SSM cache's specs: batch over (pod, data) when
    divisible, else sequence over "data"; heads (or the sequence) over
    "model"."""
    dp_axes, dp_n = _dp_world(mesh)
    model_n = mesh_sizes(mesh).get("model", 1)

    def spec_of(path, shape):
        if len(shape) <= 1:
            return P()
        axes: list = [None] * len(shape)
        if len(shape) >= 3:
            if shape[1] % dp_n == 0 and shape[1] >= dp_n:
                axes[1] = dp_axes
            elif (path.endswith("/k") or path.endswith("/v")
                  or path.endswith("_scale") or path.endswith("/v_err")):
                if shape[2] % dp_n == 0:
                    axes[2] = dp_axes
            if ((path.endswith("_scale") or path.endswith("/v_err"))
                    and len(shape) == 4):
                if shape[2] % model_n == 0 and shape[2] >= model_n:
                    axes[2] = "model"
            if (path.endswith("/k") or path.endswith("/v")) and len(shape) == 5:
                if (axes[2] is None and shape[2] % model_n == 0
                        and shape[2] >= model_n):
                    axes[2] = "model"
                elif shape[3] % model_n == 0 and shape[3] >= model_n:
                    axes[3] = "model"
                elif shape[4] % model_n == 0 and shape[4] >= model_n:
                    axes[4] = "model"
            if path.endswith("/ssm") and len(shape) == 5:
                if shape[2] % model_n == 0:
                    axes[2] = "model"
        return P(*axes)

    paths = dict(_walk(cache_shapes))
    return _rebuild(cache_shapes, {p: spec_of(p, tuple(leaf.shape))
                                   for p, leaf in paths.items()})


def serve_cache_pspecs(cache_shapes: Any, mesh) -> Any:
    """The serving pool's specs: slots over ("pod",) "data" where the pool
    size divides the DP world (no ``MIN_SHARD_DIM`` floor), KV heads over
    "model" where they divide it; the int8 cache's scales and ``v_err``
    follow their payload. A paged pool (a ``page_table`` leaf; payload
    ``[L, NP, pg, H(, hd)]``) shards heads alone: pages, page tables and the
    dense ``kpos`` / ``pos`` replicate (its dispatches address pages through
    data-dependent lookups). Anything non-divisible replicates."""
    dp_axes, dp_n = _dp_world(mesh)
    model_n = mesh_sizes(mesh).get("model", 1)
    paths = dict(_walk(cache_shapes))
    paged = any(p.rsplit("/", 1)[-1] == "page_table" for p in paths)

    def spec_of(path, shape):
        axes: list = [None] * len(shape)
        name = path.rsplit("/", 1)[-1]
        if name in ("kpos", "pos"):                     # [B, S] / [B]
            if (not paged and shape and shape[0] % dp_n == 0
                    and shape[0] >= dp_n):
                axes[0] = dp_axes
            return P(*axes)
        if name in ("k", "v", "k_scale", "v_scale", "v_err") and len(shape) >= 4:
            if not paged and shape[1] % dp_n == 0 and shape[1] >= dp_n:
                axes[1] = dp_axes                       # slot axis
            if shape[3] % model_n == 0 and shape[3] >= model_n:
                axes[3] = "model"                       # heads
            return P(*axes)
        return P(*axes)

    return _rebuild(cache_shapes, {p: spec_of(p, tuple(leaf.shape))
                                   for p, leaf in paths.items()})


def payload_scale_pairs(tree: Any, prefix: str = "") -> list:
    """Every (q_path, scale_path) pair of QTensor leaves in a params tree,
    in ``_walk`` path notation."""
    pairs: list = []
    if isinstance(tree, QTensor):
        pairs.append((f"{prefix}/q", f"{prefix}/scale"))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            pairs.extend(payload_scale_pairs(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            pairs.extend(payload_scale_pairs(v, f"{prefix}/{i}"))
    return pairs


def spec_paths(spec_tree: Any, prefix: str = ""):
    """Yield (path, PartitionSpec) pairs from a spec tree (whole specs at a
    QTensor's q / scale paths, never their elements)."""
    if isinstance(spec_tree, P):
        yield prefix, spec_tree
    elif isinstance(spec_tree, QTensorSpec):
        yield f"{prefix}/q", spec_tree.q
        yield f"{prefix}/scale", spec_tree.scale
    elif isinstance(spec_tree, dict):
        for k, v in spec_tree.items():
            yield from spec_paths(v, f"{prefix}/{k}")
    elif isinstance(spec_tree, (list, tuple)):
        for i, v in enumerate(spec_tree):
            yield from spec_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, spec_tree


def mesh_coords(mesh) -> dict:
    """{axis: this rank's index along it} on a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def block(size: int, axes, mesh) -> slice:
    """This rank's block of a dim of ``size`` placed on ``axes`` (None, an
    axis name or a tuple of them, the first the slowest)."""
    if axes is None:
        return slice(None)
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    n, i = 1, 0
    for a in ((axes,) if isinstance(axes, str) else axes):
        n, i = n * sizes[a], i * sizes[a] + coords[a]
    if size % n:
        raise ValueError(f"a dim of {size} does not divide over {axes} ({n})")
    step = size // n
    return slice(i * step, (i + 1) * step)


def local_block(t, spec: P, mesh):
    """``t`` cut to this rank's block under ``spec`` (a view; the tensor
    itself where the spec replicates)."""
    index = tuple(block(t.shape[d], a, mesh) for d, a in enumerate(spec))
    if all(s == slice(None) for s in index):
        return t
    return t[index]


def unshard_tree(tree: Any, specs: Any, mesh) -> Any:
    """The inverse of ``shard_tree``: every leaf of this rank's ``tree``
    gathered whole over the axes its spec in ``specs`` places it on (a
    dim over several axes gathered over the last first), the same on
    every rank, bit for bit (``collectives.all_gather``). Dicts, lists,
    tuples and NamedTuples keep their types."""
    from . import collectives as coll

    if isinstance(tree, dict):
        return {k: unshard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [unshard_tree(v, specs[i], mesh) for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(
            kids)
    for d, a in enumerate(specs):
        for axis in reversed((a,) if isinstance(a, str) else tuple(a or ())):
            tree = coll.all_gather(tree, d, mesh.get_group(axis))
    return tree


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` cut to this rank's block of ``mesh`` under its
    spec in ``specs`` (a tree of the same structure) — the port's
    ``named_shardings`` + ``device_put``. Cut leaves are contiguous; a
    QTensor's payload keeps its K-major storage (a column cut of it is a
    view, a cut along K a copy)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, QTensorSpec):
        kids = [shard_tree(v, specs[i], mesh) for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(
            kids)
    if isinstance(tree, QTensor):
        return QTensor(k_major(local_block(tree.q, specs.q, mesh)),
                       local_block(tree.scale, specs.scale, mesh).contiguous(),
                       tree.mode)
    cut = local_block(tree, specs, mesh)
    return cut if cut is tree else cut.contiguous()


class NamedSharding(NamedTuple):
    """A spec bound to its mesh: the rank's block of a leaf
    (``local_block``), as JAX's ``NamedSharding`` places one."""
    mesh: Any
    spec: P


def named_shardings(spec_tree: Any, mesh) -> Any:
    """The spec tree with every spec bound to ``mesh`` (a QTensor's place
    keeps its ``QTensorSpec`` of two)."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, QTensorSpec):
        return QTensorSpec(NamedSharding(mesh, spec_tree.q),
                           NamedSharding(mesh, spec_tree.scale),
                           spec_tree.mode)
    if isinstance(spec_tree, dict):
        return {k: named_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        kids = [named_shardings(v, mesh) for v in spec_tree]
        return (type(spec_tree)(*kids) if hasattr(spec_tree, "_fields")
                else type(spec_tree)(kids))
    return spec_tree


def opt_spec_tree(p_spec: Any):
    """The AdamW state's specs: the step replicated, each moment placed as
    its parameter (the reference's ``_opt_spec_tree``)."""
    from ..optim.adamw import AdamWState

    return AdamWState(P(), p_spec, p_spec)


def block_shape(shape, spec: P, mesh) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    sizes = mesh_sizes(mesh)
    out = []
    for d, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = math.prod(sizes[x] for x in ((a,) if isinstance(a, str)
                                         else (a or ())))
        if d % n:
            raise ValueError(f"a dim of {d} does not divide over {a} ({n})")
        out.append(d // n)
    return tuple(out)


def block_bytes(shapes: Any, specs: Any, mesh) -> int:
    """The bytes a rank holds of the tree ``shapes`` (tensors, meta ones
    too) placed by ``specs`` on ``mesh``: each leaf's block, its dtype's
    item size a element."""
    flat = dict(spec_paths(specs))
    total = 0
    for path, leaf in _walk(shapes):
        total += (math.prod(block_shape(tuple(leaf.shape), flat[path], mesh))
                  * leaf.element_size())
    return total
