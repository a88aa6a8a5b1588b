"""The kernel registry every serving op of the port resolves through.

Counterpart of ``repro.kernels.dispatch``:

  * ``@register_impl(op, tier, pad=...)`` registers one implementation of
    ``op`` at one tier — ``cuda`` (the hand-written Hopper kernel) or
    ``torch`` (the plain PyTorch version, arithmetic in the JAX ``ref.py``
    order); ``backends(op)`` lists an op's tiers.
  * ``resolve(op, like, backend=None)`` picks the tier as the JAX registry
    does: an explicit ``backend`` argument wins, then the tier a caller set
    for a block of calls (``tier_scope``: the serving engine's ``backend=``
    argument), then the ``REPRO_KERNEL_BACKEND`` environment variable
    (``cuda`` | ``torch``), then the tensor's device — the kernel for a
    CUDA tensor, the plain version for a CPU tensor. The JAX package reads
    the same variable; its own tier names (``pallas``, ``xla``,
    ``interpret``, ``ref``) are not tiers here and read as unset, so a
    setting meant for the JAX package never moves the port off its kernels.
    Any other value raises. ``cuda`` for a CPU tensor raises, as does a tier
    no impl of the op registered. Nothing falls back: if the CUDA kernel
    cannot build or launch, the call raises. ``active_tier`` says which
    tier a call would take (the launcher prints it).
    ``REPRO_FUSED_DECODE`` (``fused_decode.ops.fusion_enabled``) picks a
    route through the ops, as in the JAX package, never a tier.
  * ``@register_spec(op)`` registers the op's smoke-shape argument builder;
    ``iter_specs`` (through ``kernels.serving_kernel_specs``) enumerates
    them.
  * Every kernel wrapper calls ``count_launch(op)`` right where it launches
    its kernel, and nowhere else, so a run can show that its main path went
    through the kernels (``launch_counts`` / ``reset_launch_counts``). The
    count is a host counter, so a CUDA graph's replay does not tick it: the
    serving engine's graphs (``serving/graphs.py``) take back what their
    capture counted (nothing ran) and add it again at every replay through
    ``add_launches``. So ``launch_counts`` says how many launches of each
    kernel ran on the card, eagerly or replayed.
  * While a graph recorder is open (``recording``: the graph linter's
    ``analysis.lint.graph_model.GraphRecorder``), ``resolve`` hands out a
    wrapper of the impl that runs it inside the recorder's kernel scope:
    every aten op of the call is tagged with the op, and the call is one
    kernel node carrying its arguments' dtypes and shapes (at the ``cuda``
    tier the only trace of the kernel, a ``ctypes`` call the dispatcher
    never sees). With no recorder open ``resolve`` returns the impl
    itself, so launch counts and CUDA-graph captures are untouched.
  * ``stream_scratch`` is the one per-stream zero scratch of the kernels
    that take a maximum across CTAs (the quantize-out epilogues of both
    GEMMs and of the fused decode). A buffer once handed out is never
    freed, since a captured graph may hold its address.

Padding is policy here too: ``_pad_to`` is the one helper, and every impl
declares its pad convention — ``"zero"`` (GEMMs: zero rows/cols contribute
exact zeros) or ``"zero-scale"`` (attention: padded positions carry scale 0,
the "invalid" marker). Two impls of one op declaring different conventions
is an error at import time. The CUDA kernels zero-fill their own tiles, so
no caller reads the declared convention yet; it records the contract the
plain tiers and any later padded kernel keep to.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

ENV_VAR = "REPRO_KERNEL_BACKEND"

#: implementation tiers, in display order
TIERS = ("cuda", "torch")
#: the JAX package's tier names: ``REPRO_KERNEL_BACKEND`` set to one of
#: them is meant for that package and reads as unset here
JAX_TIER_NAMES = ("pallas", "xla", "interpret", "ref")

#: pad/mask conventions an impl may declare (None = op never pads)
PAD_CONVENTIONS = ("zero", "zero-scale")

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_PAD: Dict[str, str] = {}
_SPECS: Dict[str, Callable] = {}
# the tier of the innermost tier_scope (None: none is open)
_SCOPE: list = [None]
_LAUNCHES: Dict[str, int] = {}
# {(device index, stream): uint32 scratch}, left zero by every kernel
_SCRATCH: Dict[tuple, torch.Tensor] = {}
# the buffers a larger request replaced: kept alive for the graphs that
# captured them
_OUTGROWN: list = []
# the open graph recorders, innermost last
_RECORDERS: list = []


def _pad_to(x: torch.Tensor, m: int, dim: int) -> torch.Tensor:
    """Right-pad ``x`` along ``dim`` to a multiple of ``m`` (zeros)."""
    pad = (-x.shape[dim]) % m
    if pad == 0:
        return x
    dim = dim % x.ndim
    widths = [0, 0] * (x.ndim - dim - 1) + [0, pad]
    return F.pad(x, widths)


def register_impl(op: str, tier: str, *, pad: Optional[str] = None):
    """Decorator: register ``fn`` as ``op``'s implementation at ``tier``.
    All impls of an op must agree on ``pad`` (or declare nothing)."""
    if tier not in TIERS:
        raise ValueError(f"register_impl({op!r}): unknown tier {tier!r}; "
                         f"tiers are {TIERS}")
    if pad is not None and pad not in PAD_CONVENTIONS:
        raise ValueError(f"register_impl({op!r}, {tier!r}): unknown pad "
                         f"convention {pad!r}; conventions are "
                         f"{PAD_CONVENTIONS}")

    def deco(fn: Callable) -> Callable:
        impls = _REGISTRY.setdefault(op, {})
        if tier in impls and impls[tier] is not fn:
            raise ValueError(f"register_impl: {op!r} already has a {tier!r} "
                             f"impl ({impls[tier].__name__}); refusing to "
                             f"shadow it with {fn.__name__}")
        if pad is not None:
            prev = _PAD.get(op)
            if prev is not None and prev != pad:
                raise ValueError(
                    f"register_impl: {op!r} impls disagree on the pad "
                    f"convention — existing impls declare {prev!r}, "
                    f"{fn.__name__} ({tier!r}) declares {pad!r}")
            _PAD[op] = pad
        impls[tier] = fn
        _LAUNCHES.setdefault(op, 0)
        return fn

    return deco


def ops() -> tuple:
    """The registered op names, sorted."""
    return tuple(sorted(_REGISTRY))


def pad_convention(op: str) -> Optional[str]:
    _registered(op)
    return _PAD.get(op)


def _registered(op: str) -> Dict[str, Callable]:
    try:
        return _REGISTRY[op]
    except KeyError:
        raise KeyError(f"unknown kernel op {op!r}; registered ops: "
                       f"{', '.join(sorted(_REGISTRY)) or '(none)'}") from None


def backends(op: str) -> tuple:
    """The tiers ``op`` has implementations for, in tier order."""
    impls = _registered(op)
    return tuple(t for t in TIERS if t in impls)


def tier_for(like: torch.Tensor) -> str:
    """``cuda`` for a CUDA tensor, ``torch`` for a CPU tensor."""
    if like.device.type == "cuda":
        return "cuda"
    if like.device.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel tier for device {like.device}")


@contextlib.contextmanager
def tier_scope(backend: Optional[str]):
    """Resolve every op called inside the block at ``backend`` (None: no
    change), unless a call names its own. The serving engine opens one for
    its ``backend=`` argument."""
    if backend is not None and backend not in TIERS:
        raise ValueError(f"unknown kernel tier {backend!r}; tiers are "
                         f"{', '.join(TIERS)}")
    _SCOPE.append(backend if backend is not None else _SCOPE[-1])
    try:
        yield
    finally:
        _SCOPE.pop()


def _env_tier() -> Optional[str]:
    """The tier ``REPRO_KERNEL_BACKEND`` names, or None (unset, or one of
    the JAX package's tier names)."""
    env = os.environ.get(ENV_VAR) or None
    if env is None or env in TIERS:
        return env
    if env in JAX_TIER_NAMES:
        return None
    raise ValueError(f"{ENV_VAR}={env!r} is not a kernel tier; tiers are "
                     f"{', '.join(TIERS)}")


def active_tier(like: torch.Tensor, backend: Optional[str] = None) -> str:
    """The tier a call on ``like`` takes: an explicit ``backend`` > the open
    ``tier_scope`` > ``REPRO_KERNEL_BACKEND`` > the device ``like`` lives
    on."""
    return backend or _SCOPE[-1] or _env_tier() or tier_for(like)


def resolve(op: str, like: torch.Tensor,
            backend: Optional[str] = None) -> Callable:
    """``op``'s implementation at ``active_tier(like, backend)``."""
    impls = _registered(op)
    tier = active_tier(like, backend)
    if tier not in impls:
        raise ValueError(f"op {op!r} has no {tier!r} implementation; "
                         f"registered tiers: {', '.join(backends(op))}")
    if tier == "cuda" and like.device.type != "cuda":
        raise ValueError(f"op {op!r}: the {tier!r} tier runs on a CUDA "
                         f"tensor, got one on {like.device}")
    if _RECORDERS:
        return _scoped(op, tier, impls[tier], _RECORDERS[-1])
    return impls[tier]


def _scoped(op: str, tier: str, impl: Callable, recorder) -> Callable:
    """``impl`` run inside ``recorder``'s kernel scope for ``op``."""

    @functools.wraps(impl)
    def call(*args, **kwargs):
        with recorder.kernel_scope(op, tier, args, kwargs):
            return impl(*args, **kwargs)

    return call


@contextlib.contextmanager
def recording(recorder):
    """Hand ``recorder`` (a ``GraphRecorder``) every kernel call that
    ``resolve`` gives out inside the block."""
    _RECORDERS.append(recorder)
    try:
        yield recorder
    finally:
        _RECORDERS.remove(recorder)


def register_spec(op: str):
    """Decorator: register ``op``'s smoke-shape spec builder, a callable
    ``(*, device, **shape_kw) -> (fn, args, kwargs)``."""

    def deco(build: Callable) -> Callable:
        if op in _SPECS and _SPECS[op] is not build:
            raise ValueError(f"register_spec: {op!r} already has a spec")
        _SPECS[op] = build
        return build

    return deco


def iter_specs(**shape_kw) -> Dict[str, Any]:
    """{op: (fn, args, kwargs)} over every registered spec builder."""
    return {op: _SPECS[op](**shape_kw) for op in sorted(_SPECS)}


def count_launch(op: str) -> None:
    """Called by a kernel wrapper exactly where it launches its kernel."""
    _LAUNCHES[op] = _LAUNCHES.get(op, 0) + 1


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` ({op: launches}) to the counts: a CUDA graph replay
    adds what its capture counted (a capture takes it back, negated)."""
    for op, n in delta.items():
        _LAUNCHES[op] = _LAUNCHES.get(op, 0) + n


def launch_counts() -> Dict[str, int]:
    """{op: kernel launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for op in _LAUNCHES:
        _LAUNCHES[op] = 0


def stream_scratch(n: int, device: torch.device) -> torch.Tensor:
    """A zeroed uint32 buffer (held as int32) of at least ``n`` for the
    current stream. Every kernel that uses it leaves what it used zero, so
    one buffer per stream serves every call on it, in stream order. Call
    it eagerly before a CUDA graph captures a launch that takes it (the
    engine's graphs run a masked dispatch on the capture stream first), so
    that the graph holds a buffer that is allocated and zero."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros((max(n, 4096),), dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf
