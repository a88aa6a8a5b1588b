"""The op-graph model the graph linter reads — counterpart of the
reference's ``hlo_model`` (optimized HLO text parsed into instructions).

The port has no compiled module to parse: a serve path is eager PyTorch
plus the hand-written kernels, called through ``ctypes``
(``kernels/_build.py``), and it writes the KV pool in place. Neither
``torch.fx`` nor ``torch.export`` sees a ``ctypes`` call or keeps an
in-place write of a tensor the graph did not make, so a path is RECORDED
instead: it runs once under a ``TorchDispatchMode`` (``GraphRecorder``),
which sees every aten op as the dispatcher runs it, while the kernel
registry (``kernels.dispatch.resolve``) reports each kernel call it hands
out. What the recorder keeps:

  * :class:`OpRecord` — one aten op: its name, its inputs' and outputs'
    dtypes and shapes, the storages they live in, the arguments it writes,
    and the kernel op whose call it ran inside (``kernel``; None outside
    every kernel);
  * :class:`KernelNode` — one kernel call (the outermost one, if a plain
    version calls another op): the op, its tier, and its tensor arguments'
    dtypes and shapes; at the ``cuda`` tier it is the one node the card
    sees, the kernel itself being invisible to the dispatcher;
  * :class:`OpGraph` — a path's records and kernel nodes, the logical
    collectives it reported (``sharding.collectives``), and each pool
    leaf's storage and address before and after the call.

A **convert** is any op with an int8 tensor input and a floating output
(``converts``): eager torch multiplies an int8 tensor by a float scale in
ONE ``aten.mul.Tensor`` (type promotion), with no separate cast op, so a
cast-op match alone would miss the dequantize-multiply.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: dtype name → bytes of one element, for the dtypes a serve path moves
DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8,
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "complex64": 8, "complex128": 16,
}

_FLOATS = ("float16", "bfloat16", "float32", "float64")


_NAMES: dict = {}


def dtype_name(dtype) -> str:
    """``torch.int8`` → ``"int8"`` (a name passes through)."""
    if isinstance(dtype, str):
        return dtype
    name = _NAMES.get(dtype)
    if name is None:
        name = _NAMES[dtype] = str(dtype).replace("torch.", "")
    return name


def type_bytes(dtype, shape=()) -> int:
    """Bytes of a ``dtype`` tensor of ``shape`` (a scalar for ``()``).
    A dtype this table lacks raises: a new dtype in a budget is a signal,
    never a silent 0."""
    name = dtype_name(dtype)
    try:
        width = DTYPE_BYTES[name]
    except KeyError:
        raise ValueError(f"type_bytes: no width for dtype {name!r}; add it "
                         f"to repro_torch.analysis.lint.graph_model."
                         f"DTYPE_BYTES") from None
    return math.prod(int(d) for d in shape) * width


def type_str(dtype, shape) -> str:
    """``"int8[4,32,2,16]"``: a tensor type as the contracts spell it."""
    return f"{dtype_name(dtype)}[{','.join(str(int(d)) for d in shape)}]"


def storage_id(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its views share it; a meta tensor
    has one of its own too)."""
    return t.untyped_storage()._cdata


class TensorInfo(NamedTuple):
    dtype: str
    shape: tuple
    storage: int

    @property
    def nbytes(self) -> int:
        return type_bytes(self.dtype, self.shape)


def _info(t: torch.Tensor) -> TensorInfo:
    name = _NAMES.get(t.dtype)
    return TensorInfo(name if name is not None else dtype_name(t.dtype),
                      tuple(t.shape), t.untyped_storage()._cdata)


def _tensors(x, out=None) -> list:
    """Every tensor in ``x`` (nested lists, tuples and dicts), in order;
    the recorder calls it on every op's arguments, so it appends into one
    list and skips the ints of a shape."""
    if out is None:
        out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple, dict)):
                _tensors(v, out)
    elif isinstance(x, dict):
        _tensors(tuple(x.values()), out)
    return out


@dataclasses.dataclass
class OpRecord:
    """One aten op as the dispatcher ran it."""
    op: str                      # e.g. "aten.mul.Tensor"
    inputs: tuple                # TensorInfo of each tensor argument
    outputs: tuple               # TensorInfo of each tensor result
    mutated: tuple               # TensorInfo of each argument it writes
    kernel: Optional[str]        # the enclosing kernel op, None outside

    @property
    def allocated(self) -> tuple:
        """The results in a storage none of its arguments had."""
        seen = {t.storage for t in self.inputs}
        return tuple(t for t in self.outputs if t.storage not in seen)

    @property
    def is_convert(self) -> bool:
        return (any(t.dtype == "int8" for t in self.inputs)
                and any(t.dtype in _FLOATS for t in self.outputs))


@dataclasses.dataclass
class KernelNode:
    op: str
    tier: str                    # "cuda" | "torch"
    args: tuple                  # (dtype, shape) of each tensor argument


@dataclasses.dataclass
class ConvertRecord:
    """One int8 → float convert: its float result's shape and dtype, the
    op, and the kernel it ran inside (None: it materializes in memory)."""
    shape: tuple
    dtype: str
    op: str
    kernel: Optional[str]

    @property
    def elems(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return type_bytes(self.dtype, self.shape)

    @property
    def in_kernel(self) -> bool:
        return self.kernel is not None


@dataclasses.dataclass
class OpGraph:
    """One recorded path."""
    name: str
    records: list = dataclasses.field(default_factory=list)
    kernels: list = dataclasses.field(default_factory=list)
    # (kind, dtype name, shape, bytes) of each logical collective's result
    collectives: list = dataclasses.field(default_factory=list)
    # {pool leaf: (storage, data_ptr)} around the call
    pool_before: dict = dataclasses.field(default_factory=dict)
    pool_after: dict = dataclasses.field(default_factory=dict)
    # {storage: name} of tensors the engine holds beside the pool (a paged
    # engine's dense view of it)
    views: dict = dataclasses.field(default_factory=dict)
    # {kernel op: launches} the call counted (on the card; none on the CPU)
    launches: dict = dataclasses.field(default_factory=dict)

    def converts(self) -> list:
        out = []
        for r in self.records:
            if not r.is_convert:
                continue
            res = next(t for t in r.outputs if t.dtype in _FLOATS)
            out.append(ConvertRecord(res.shape, res.dtype, r.op, r.kernel))
        return out

    def kernel_counts(self, tier: Optional[str] = None) -> dict:
        """{kernel op: nodes} (at ``tier``, or every tier)."""
        out: dict = {}
        for k in self.kernels:
            if tier is None or k.tier == tier:
                out[k.op] = out.get(k.op, 0) + 1
        return out


def pool_state(leaves: dict) -> dict:
    """{name: (storage, data_ptr)} of a {name: tensor} pool."""
    return {name: (storage_id(t), t.data_ptr())
            for name, t in leaves.items()}


_OPS: dict = {}


class GraphRecorder(TorchDispatchMode):
    """Record every aten op run inside it into an ``OpGraph``; the kernel
    registry calls ``kernel_scope`` around each kernel call it hands out
    while this recorder is open (``kernels.dispatch.recording``)."""

    def __init__(self, graph: OpGraph):
        super().__init__()
        self.graph = graph
        self._scope: list = []

    @contextlib.contextmanager
    def kernel_scope(self, op: str, tier: str, args, kwargs):
        if not self._scope:
            self.graph.kernels.append(KernelNode(op, tier, tuple(
                (dtype_name(t.dtype), tuple(int(d) for d in t.shape))
                for t in _tensors((args, kwargs)))))
        self._scope.append(op)
        try:
            yield
        finally:
            self._scope.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # keyed by identity: an OpOverload hashes in Python, and the
        # recorder sees every op of a path
        op = _OPS.get(id(func))
        if op is None:
            # the op's name and the (position, name) of each argument it
            # writes, read once from its schema (func kept: its id stays
            # its own)
            op = _OPS[id(func)] = (str(func), tuple(
                (i, a.name) for i, a in enumerate(func._schema.arguments)
                if a.alias_info is not None and a.alias_info.is_write),
                func)
        written = []
        for i, name in op[1]:
            _tensors(args[i] if i < len(args) else kwargs.get(name), written)
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        self.graph.records.append(OpRecord(
            op=op[0],
            inputs=tuple(map(_info, ins)),
            outputs=tuple(map(_info, _tensors(out))),
            mutated=tuple(map(_info, written)),
            kernel=self._scope[0] if self._scope else None))
        return out


def record_graph(name: str, fn: Callable, args=(), kwargs=None, *,
                 pool: Optional[Callable[[], dict]] = None,
                 views: Optional[dict] = None) -> OpGraph:
    """Run ``fn(*args, **kwargs)`` once under a recorder and return its
    ``OpGraph``. ``pool`` returns the KV pool's {leaf: tensor} (read
    before and after the call); ``views`` are {name: tensor} the engine
    holds beside the pool. ``launches`` holds the kernel launches the
    call counted."""
    from ...kernels.dispatch import launch_counts, recording
    from ...sharding.collectives import record_collectives

    graph = OpGraph(name)
    before = launch_counts()
    graph.views = {storage_id(t): n for n, t in (views or {}).items()}
    if pool is not None:
        graph.pool_before = pool_state(pool())
    with record_collectives() as coll:
        rec = GraphRecorder(graph)
        with rec, recording(rec):
            fn(*args, **(kwargs or {}))
    graph.collectives = [(kind, dtype_name(dt), tuple(shape), nbytes)
                         for kind, dt, shape, nbytes in coll.events]
    graph.launches = {op: n - before.get(op, 0)
                      for op, n in launch_counts().items()
                      if n != before.get(op, 0)}
    if pool is not None:
        graph.pool_after = pool_state(pool())
    return graph
