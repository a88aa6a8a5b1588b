"""Atomic checkpointer of plain tensor trees — port of
``repro.checkpoint.checkpointer``, writing the same on-disk layout, so a
checkpoint written by either package restores in the other:

    <dir>/step_<N>.tmp-<pid>/   (write)  →  atomic rename →  <dir>/step_<N>/
        manifest.json           the leaf inventory: count, shapes, dtypes
        skeleton.json           the tree's structure, every leaf a 0
        arr_<i>.npy             one file per leaf (host arrays)

A crash mid-write leaves only a ``.tmp`` directory, which restore ignores
and the next ``Checkpointer`` removes; a visible ``step_N`` is complete.
``save(..., blocking=False)`` snapshots the leaves to the host, then writes
on a worker thread (``wait()`` joins it; the next save waits first). The
most recent ``keep`` steps are kept.

Leaf order (hazard read off the reference): ``jax.tree.flatten`` visits a
dict's keys SORTED and a list or tuple (a ``NamedTuple`` such as
``AdamWState`` among them) in order, and ``arr_i`` is the i-th leaf of
that walk. ``_flatten`` here walks the same way; any other order would bind
``arr_i`` to the wrong leaf across packages. So a training checkpoint of
``(params, AdamWState)`` written by either package restores in the other,
leaf for leaf, through ``restore(target_tree)``, which rebuilds the
target's own structure (its ``NamedTuple`` types included).

bfloat16 without ``ml_dtypes`` (hazard): the JAX package's ``np.save`` of a
bfloat16 array writes a ``'<V2'`` payload, and its manifest says
``bfloat16``. The port reads such a leaf as raw 2-byte words and views them
as ``torch.bfloat16``. It writes a bfloat16 leaf with the header descr
``'bfloat16'``, which ``np.load`` resolves wherever ``ml_dtypes`` is
imported (as it is under JAX), so the JAX package loads it as bfloat16; the
port reads it back the same raw way. A leaf of any other dtype numpy does
not know is refused with a message that names it.

Over a mesh (``shardings``: a tree of ``sharding.partition.NamedSharding``
beside the tree, ``named_shardings``' output): ``save`` gathers every leaf
whole over the axes its spec names (``unshard_tree``, bit for bit) on the
calling thread, every rank, before any writer starts — the writer thread
runs no collective — and the mesh's rank 0 alone writes the host arrays,
so the files are the one-device layout either package reads;
``restore(target, shardings=)`` reads each leaf whole and keeps this
rank's block (the reference's ``device_put`` onto the new mesh), after
every rank has waited for its writer and met the others at a barrier, so
all read the same step. ``on_mesh`` binds a target and its shardings for
the fault-tolerant loop, whose ``save`` / ``restore(state)`` calls then
take the mesh path.
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..sharding.partition import local_block

_BF16 = "bfloat16"


class CheckpointError(ValueError):
    """A leaf or a checkpoint the checkpointer cannot write or read."""


def _flatten(tree, path=()) -> list:
    """[(path, leaf)] in ``jax.tree.flatten``'s order: dict keys sorted,
    lists and tuples in order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, path + (i,)))
        return out
    return [(path, tree)]


def _unflatten(skeleton, leaves: list):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(skeleton)


def _rebuild(target, leaves: list):
    """The target tree's structure — dicts in their own key order, lists,
    tuples and NamedTuples as their own types — over ``leaves`` given in
    ``_flatten``'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            kids = [build(v) for v in node]
            if hasattr(node, "_fields"):                  # a NamedTuple
                return type(node)(*kids)
            return type(node)(kids)
        return next(it)

    return build(target)


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return 0


def _name(path) -> str:
    return "/".join(str(p) for p in path) or "<root>"


def _to_host(path, leaf) -> tuple:
    """(numpy array, manifest dtype) of one leaf; a bfloat16 tensor becomes
    its raw uint16 words."""
    if isinstance(leaf, torch.Tensor):
        # a copy, always: an asynchronous save writes it while the next
        # (donated) train step updates the leaf in place
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        try:
            a = t.numpy()
        except TypeError as e:
            raise CheckpointError(
                f"leaf {_name(path)}: {t.dtype} has no numpy dtype the "
                "checkpoint can hold") from e
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.kind not in "biufc":
        raise CheckpointError(
            f"leaf {_name(path)}: dtype {a.dtype} is not a numeric numpy "
            "dtype the checkpoint can hold")
    return np.ascontiguousarray(a), str(a.dtype)


def _write_leaf(fname: str, a: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(fname, a)
        return
    with open(fname, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16, "fortran_order": False, "shape": a.shape})
        f.write(a.astype("<u2").tobytes())


def _read_raw_words(fname: str) -> np.ndarray:
    """The 2-byte payload of a .npy file as uint16, parsing the header by
    hand (its descr, ``'<V2'`` or ``'bfloat16'``, means nothing to numpy
    without ``ml_dtypes``)."""
    with open(fname, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        size = int.from_bytes(f.read(2 if major == 1 else 4), "little")
        header = ast.literal_eval(f.read(size).decode("latin1"))
        data = f.read()
    shape = tuple(header["shape"])
    words = np.frombuffer(data, dtype="<u2", count=int(np.prod(shape)))
    order = "F" if header["fortran_order"] else "C"
    return words.reshape(shape, order=order)


def _read_leaf(fname: str, path, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        words = np.ascontiguousarray(_read_raw_words(fname))
        return torch.from_numpy(words.view(np.int16).copy()).view(
            torch.bfloat16)
    try:
        a = np.load(fname, allow_pickle=False)
    except (TypeError, ValueError) as e:
        raise CheckpointError(
            f"leaf {_name(path)} ({fname}): dtype {dtype!r} is not one the "
            f"port can read: {e}") from e
    if a.dtype.kind not in "biufc" or str(a.dtype) != dtype:
        raise CheckpointError(
            f"leaf {_name(path)} ({fname}): payload dtype {a.dtype} where the "
            f"manifest says {dtype!r}; the port reads numeric numpy dtypes "
            "and bfloat16")
    return torch.from_numpy(np.array(a, copy=True))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._cleanup_tmp()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False,
             shardings: Any = None) -> None:
        """Write ``tree`` (nested dicts / lists of tensors or numpy arrays)
        as step ``step``; with ``shardings``, this rank's blocks of it,
        gathered whole first (every rank calls; rank 0 writes)."""
        self.wait()
        if shardings is not None:
            tree = _gather_whole(tree, shardings)
            if dist.get_rank() != 0:
                return
        pairs = _flatten(tree)
        host = [_to_host(path, leaf) for path, leaf in pairs]
        spec = {"step": step, "n_leaves": len(host),
                "shapes": [list(a.shape) for a, _ in host],
                "dtypes": [d for _, d in host]}
        skeleton = _skeleton(tree)

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp-{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            for i, (a, dtype) in enumerate(host):
                _write_leaf(os.path.join(tmp, f"arr_{i}.npy"), a, dtype)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(spec, f)
            with open(os.path.join(tmp, "skeleton.json"), "w") as f:
                json.dump(skeleton, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and ".tmp" not in d
                 and os.path.exists(os.path.join(self.dir, d, "manifest.json"))]
        return max(steps) if steps else None

    def restore(self, target_tree: Any, step: Optional[int] = None,
                device: Optional[torch.device] = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore step ``step`` (default: the latest) into the structure of
        ``target_tree``: the i-th leaf of ``_flatten(target_tree)`` reads
        ``arr_i``, with the checkpoint's dtype, onto ``device`` (default:
        that target leaf's device; with ``shardings`` and a meta target,
        the mesh's device). The leaf count and every shape must match the
        target's; a mismatch raises ``CheckpointError`` naming the leaf.
        ``shardings`` (a tree of ``NamedSharding`` beside the target, whose
        leaves then may be meta tensors of the whole shapes) keeps each
        leaf's block on this rank of its mesh; every rank calls. Returns
        ``(tree, step)``."""
        if shardings is not None:
            self.wait()
            dist.barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        pairs = _flatten(target_tree)
        with open(os.path.join(d, "manifest.json")) as f:
            spec = json.load(f)
        if spec["n_leaves"] != len(pairs):
            raise CheckpointError(f"{d}: the checkpoint has {spec['n_leaves']} "
                                  f"leaves, the target {len(pairs)}")
        placed = (None if shardings is None else
                  [sh for _, sh in _flatten_shardings(shardings)])
        if placed is not None and len(placed) != len(pairs):
            raise CheckpointError(f"{len(placed)} shardings for "
                                  f"{len(pairs)} target leaves")
        leaves = []
        for i, ((path, ref), dtype) in enumerate(zip(pairs, spec["dtypes"])):
            want = list(np.shape(ref) if not isinstance(ref, torch.Tensor)
                        else ref.shape)
            if list(spec["shapes"][i]) != want:
                raise CheckpointError(
                    f"leaf {_name(path)}: the checkpoint's shape "
                    f"{spec['shapes'][i]}, the target's {want}")
            t = _read_leaf(os.path.join(d, f"arr_{i}.npy"), path, dtype)
            if list(t.shape) != want:
                raise CheckpointError(
                    f"leaf {_name(path)}: arr_{i} holds shape "
                    f"{list(t.shape)}, the target's {want}")
            dev = device if device is not None else (
                ref.device if isinstance(ref, torch.Tensor) else None)
            if placed is not None:
                sh = placed[i]
                t = local_block(t, sh.spec, sh.mesh).contiguous()
                if dev is None or dev.type == "meta":
                    dev = _mesh_device(sh.mesh)
            leaves.append(t if dev is None else t.to(dev))
        return _rebuild(target_tree, leaves), step

    def on_mesh(self, target_tree: Any, shardings: Any) -> "MeshCheckpointer":
        """This checkpointer as the fault-tolerant loop's, over a mesh:
        ``target_tree`` the whole state's shapes (meta tensors will do),
        ``shardings`` its placement."""
        return MeshCheckpointer(self, target_tree, shardings)

    def restore_skeleton(self, step: Optional[int] = None,
                         device: Optional[torch.device] = None
                         ) -> tuple[Any, int]:
        """Rebuild the tree from its persisted skeleton (no target tree
        needed): plain dicts and lists of tensors, on ``device`` (default
        the CPU). Returns ``(tree, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "skeleton.json")) as f:
            skeleton = json.load(f)
        with open(os.path.join(d, "manifest.json")) as f:
            spec = json.load(f)
        paths = [p for p, _ in _flatten(skeleton)]
        if spec["n_leaves"] != len(paths):
            raise CheckpointError(f"{d}: the manifest has {spec['n_leaves']} "
                                  f"leaves, the skeleton {len(paths)}")
        leaves = []
        for i, (path, dtype) in enumerate(zip(paths, spec["dtypes"])):
            t = _read_leaf(os.path.join(d, f"arr_{i}.npy"), path, dtype)
            if list(t.shape) != list(spec["shapes"][i]):
                raise CheckpointError(
                    f"leaf {_name(path)}: shape {list(t.shape)}, the manifest "
                    f"says {spec['shapes'][i]}")
            leaves.append(t if device is None else t.to(device))
        return _unflatten(skeleton, leaves), step

    # --------------------------------------------------------------- hygiene
    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and ".tmp" not in d)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def _cleanup_tmp(self) -> None:
        for d in os.listdir(self.dir):
            if ".tmp" in d:
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)


class MeshCheckpointer:
    """A ``Checkpointer`` bound to a sharded state's whole shapes and
    placement: ``save(step, blocks)`` gathers and rank 0 writes,
    ``restore(state)`` gives every rank its blocks of the latest step,
    ``latest_step`` is the step every rank sees (after the writer and a
    barrier)."""

    def __init__(self, ckpt: Checkpointer, target_tree: Any, shardings: Any):
        self.ckpt, self.target, self.shardings = ckpt, target_tree, shardings
        self.dir = ckpt.dir

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.ckpt.save(step, tree, blocking=blocking,
                       shardings=self.shardings)

    def wait(self) -> None:
        self.ckpt.wait()

    def latest_step(self) -> Optional[int]:
        self.ckpt.wait()
        dist.barrier()
        return self.ckpt.latest_step()

    def restore(self, state: Any = None, step: Optional[int] = None):
        return self.ckpt.restore(self.target, step=step,
                                 shardings=self.shardings)


def _flatten_shardings(shardings) -> list:
    """``_flatten`` of a shardings tree, a ``NamedSharding`` a leaf."""
    from ..sharding.partition import NamedSharding

    if isinstance(shardings, NamedSharding):
        return [((), shardings)]
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings)
                for x in _flatten_shardings(shardings[k])]
    if isinstance(shardings, (list, tuple)):
        return [x for v in shardings for x in _flatten_shardings(v)]
    return [((), shardings)]


def _gather_whole(tree, shardings):
    """``tree``'s blocks gathered whole by their shardings (every rank)."""
    from ..sharding.partition import NamedSharding, unshard_tree

    if isinstance(shardings, NamedSharding):
        return unshard_tree(tree, shardings.spec, shardings.mesh)
    if isinstance(tree, dict):
        return {k: _gather_whole(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [_gather_whole(v, shardings[i]) for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(
            kids)
    return tree


def _mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: its card, or the CPU."""
    if getattr(mesh, "device_type", "cpu") == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
