"""Typed serving configuration: one dataclass is both the ``serve`` API and
(through ``build_parser``) the CLI, as in ``repro.launch.serve_config``. It
has every field of the JAX ``ServeConfig`` with the same flag, type,
default and validation; ``lint`` runs the port's graph linter
(``analysis.lint.lint_engine``) over the live engine before warmup,
warn-only, as the JAX launcher's.

``mesh`` (``--mesh DxM`` or ``PxDxM``, ``parse_mesh``) serves over a
``torch.distributed`` device mesh ("data", "model"), as the JAX
launcher's: slots over "data", weights tensor-parallel over "model"; the
launcher starts a rank a mesh position. Its backend is NCCL on the card
(a card a rank: a mesh larger than the card count raises) and gloo on the
CPU, unless ``mesh_backend`` names one — gloo on the card runs several
ranks on one card. ``serve_async`` with a mesh runs the front-end on
rank 0, the other ranks replaying its engine calls
(``serving.mesh_control``).

Besides the JAX fields, the port's own: ``layers`` (the arch cut to its
first N layers, widths kept, for a card that cannot hold the full depth),
``seed`` (of the random weights), ``device``, ``mesh_backend``,
``profile``, and ``prompt_min`` / ``gen_min`` (the trace's shortest prompt
and generation; the JAX launcher fixes both at 4). The kernel tier is the device's unless
``REPRO_KERNEL_BACKEND`` names one (``kernels.dispatch``).

``quantize`` picks the weight scheme (``w8a16``, the JAX launcher's default,
``w8a8``, or ``none``: the fp32 weights, unquantized) and ``kv_bits`` the
KV-cache precision (8: int8; 16: fp; None: what the recipe or artifact
recorded — the fp cache unless a ``kv_cache`` stage said 8), with the JAX
launcher's recipe choice: ``serve-<quantize>-kv8`` for ``kv_bits=8``, else
``serve-<quantize>``; ``recipe`` names any other pipeline recipe and
overrides ``quantize``. The default deployment is therefore the
reference's: W8A16 weights over a bf16 KV cache. ``trace=0`` (the default)
serves ``batch`` uniform requests, as in JAX; ``trace=N`` a synthetic
arrival schedule of N requests, through the async front-end with
``serve_async``.

With ``load``, the artifact's record meets this config under the JAX
launcher's precedence contract (``_ARTIFACT_POLICY``) for the fields this
config has: ``mesh`` is "cli" — an explicit ``--mesh`` re-deploys on a new
topology, else the artifact's recorded mesh is served; ``arch``, ``smoke``,
``quantize`` and ``recipe`` are "baked" — the artifact is served as saved
and an explicit differing value is reported as ignored — and ``kv_bits``
is "must-match": an explicit value other than the artifact's raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional, Tuple


#: the weight schemes the launcher serves ("none": fp32 weights)
QUANTIZE_CHOICES = ("none", "w8a16", "w8a8")


class ServeConfigError(ValueError):
    """Invalid serving configuration."""


def parse_mesh(spec) -> Optional[Tuple[int, ...]]:
    """"2x4" -> (2, 4); accepts an already-parsed tuple or None."""
    if spec is None or isinstance(spec, tuple):
        return spec
    try:
        shape = tuple(int(s) for s in str(spec).lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or any(s < 1 for s in shape):
        raise ServeConfigError(
            f"--mesh wants DxM (or PxDxM), e.g. 2x4; got {spec!r}")
    return shape


def _f(default, help=None, **cli):
    return dataclasses.field(default=default, metadata={"help": help, **cli})


@dataclasses.dataclass
class ServeConfig:
    arch: str = _f("qwen2-0.5b", "architecture id (see configs.registry)")
    smoke: bool = _f(False, "use the arch's smoke-sized config", switch=True)
    layers: Optional[int] = _f(
        None, "cut the arch to its first N layers, every width kept (a "
        "card too small for the full depth)", type=int, metavar="N")
    seed: int = _f(0, "seed of the random weights", type=int)
    quantize: str = _f("w8a16", "weight/activation scheme: int8 weights "
                       "with fp activations (w8a16), with dynamic int8 "
                       "activations (w8a8), or none (fp32); serves the "
                       "serve-<scheme>[-kv8] recipe",
                       choices=list(QUANTIZE_CHOICES))
    recipe: Optional[str] = _f(
        None, "pipeline recipe name (overrides --quantize)")
    kv_bits: Optional[int] = _f(
        None, "KV-cache precision: 8 = int8 payload + per-token/per-head "
        "scales (decode attends through the fused_decode kernel), 16 = fp. "
        "Default: what the recipe/artifact recorded (--kv-bits 8 selects "
        "the serve-<quantize>-kv8 recipe)", type=int, choices=[8, 16])
    mesh: Optional[Tuple[int, ...]] = _f(
        None, "serve sharded over a device mesh, e.g. 2x4 = (\"data\": 2, "
        "\"model\": 4) — slots shard over data, weights tensor-parallel over "
        "model (a P x D x M form adds the leading \"pod\" axis); the "
        "launcher starts D*M ranks (one card each under NCCL; --mesh-backend "
        "gloo shares one card). Default: the mesh recorded in a --load "
        "artifact, else single-device", metavar="DxM", parse=parse_mesh)
    mesh_backend: Optional[str] = _f(
        None, "the mesh's torch.distributed backend: nccl (the card's "
        "default, a card a rank) or gloo (the CPU's default; on the card, "
        "several ranks on one card, collectives through host memory)",
        choices=["nccl", "gloo"])
    device: str = _f("cuda", "cuda (default) or cpu (the plain PyTorch "
                     "versions of the kernels)")
    save: Optional[str] = _f(
        None, "persist the QuantizedModel after quantization (with --mesh: "
        "the serve-mode partition specs are recorded in the artifact)",
        metavar="DIR")
    verbose: bool = _f(False, "print per-site weight SQNR diagnostics",
                       switch=True)
    batch: int = _f(4, "without --trace: number of uniform requests",
                    type=int)
    slots: int = _f(4, "engine cache-pool size (decode batch width)", type=int)
    max_len: Optional[int] = _f(
        None, "per-slot KV capacity (default: fits prompt+gen)", type=int)
    prefill_chunk: int = _f(16, None, type=int)
    page_size: Optional[int] = _f(
        None, "switch the KV pool to the paged layout: fixed PG-position "
        "pages + per-slot page tables, with refcounted copy-on-write "
        "shared-prefix reuse (requests sharing a prompt prefix share its "
        "pages physically). Tokens are bit-identical to the contiguous "
        "pool. Default: contiguous", type=int, metavar="PG")
    num_pages: Optional[int] = _f(
        None, "page-pool size (with --page-size); default gives every slot "
        "a full ring — smaller pools admit by page demand and lean on "
        "prefix sharing and preemption", type=int)
    prefix_reuse: bool = _f(
        True, "with --page-size: disable the scheduler's prefix index "
        "(pages without sharing)", flag="--no-prefix-reuse", invert=True)
    decode_horizon: int = _f(
        8, "max decode steps fused into one device dispatch (the engine "
        "adapts the actual horizon to budgets and scheduled arrivals)",
        type=int)
    reference: bool = _f(
        False, "use the stepwise fast=False reference path (one dispatch + "
        "one host sync per token) instead of the device-resident fast path",
        switch=True)
    warmup: bool = _f(
        False, "pre-compile all pow2 prefill/horizon shapes before serving "
        "(on the card: capture their CUDA graphs; excluded from the timed "
        "run)", switch=True)
    prompt_len: int = _f(32, "longest prompt", type=int)
    gen_len: int = _f(32, "most new tokens", type=int)
    prompt_min: int = _f(4, "with --trace: shortest prompt", type=int)
    gen_min: int = _f(4, "with --trace: fewest new tokens", type=int)
    trace: int = _f(
        0, "replay a synthetic arrival schedule of N requests (mixed "
        "log-uniform lengths, Poisson arrivals)", type=int, metavar="N")
    trace_seed: int = _f(0, None, type=int)
    max_queue: Optional[int] = _f(
        None, "bound the admission queue: submissions beyond Q shed with "
        "the retryable QueueFull error (back-pressure). Default: unbounded",
        type=int, metavar="Q")
    serve_async: bool = _f(
        False, "serve the --trace through the overload-safe async front-end "
        "(serving.AsyncServer): per-request token streaming, client retry "
        "with backoff + jitter on the retryable taxonomy, circuit breaker, "
        "and priority-aware load shedding; reports the SLO view (TTFT / "
        "per-token percentiles, goodput)", switch=True)
    qps: float = _f(
        0.5, "with --serve-async: offered Poisson arrival rate in requests "
        "per engine tick (open loop)", type=float, metavar="R")
    timeout: Optional[float] = _f(
        None, "with --serve-async: per-request client timeout in engine "
        "ticks, enforced as the engine deadline (tighter of this and "
        "--deadline wins)", type=float, metavar="T")
    retry_attempts: int = _f(
        4, "with --serve-async: max submission attempts per request "
        "(retryable rejections back off with exponential backoff + full "
        "jitter)", type=int)
    breaker_cooldown: float = _f(
        16.0, "with --serve-async: circuit-breaker cooldown in engine ticks "
        "before a half-open probe", type=float)
    shed_pressure: float = _f(
        0.5, "with --serve-async: queue pressure (depth/bound) at which the "
        "lowest priority class is shed; deadlines tighten at 1.5x this "
        "value and all requests are refused at 2x (capped at 1.0)",
        type=float)
    deadline: Optional[float] = _f(
        None, "give every request a deadline of T engine ticks after its "
        "arrival; expired requests are shed (queued) or cut short (in "
        "flight) at the next step boundary and report status 'expired'",
        type=float, metavar="T")
    lint: bool = _f(
        False, "run the graph linter over this engine's recorded serve "
        "paths before serving (warn-only here; `python -m "
        "repro_torch.analysis.lint --check` is the blocking gate)",
        switch=True)
    straggler_threshold: Optional[float] = _f(
        None, "flag an engine step as a straggler when its wall time "
        "exceeds X times the EMA of recent steps (reported with the fault "
        "counters). Default: the monitor's 2.0", type=float, metavar="X")
    profile: bool = _f(False, "trace the serving loop with torch.profiler and "
                       "print device time by kernel and the device busy "
                       "share", switch=True)
    load: Optional[str] = _f(
        None, "serve a saved QuantizedModel (skips quantization; its arch, "
        "weight scheme and KV precision are the artifact's)", metavar="DIR")

    def validate(self) -> "ServeConfig":
        for name in ("slots", "prefill_chunk", "decode_horizon", "batch",
                     "prompt_len", "gen_len", "prompt_min", "gen_min"):
            if getattr(self, name) < 1:
                raise ServeConfigError(f"{name} must be >= 1")
        if self.trace < 0:
            raise ServeConfigError("trace must be >= 0 (0: --batch uniform "
                                   "requests)")
        if self.layers is not None and self.layers < 1:
            raise ServeConfigError("layers must be >= 1")
        if self.layers is not None and self.load:
            raise ServeConfigError("--layers cuts a model to quantize; a "
                                   "--load artifact is served as saved")
        if self.quantize not in QUANTIZE_CHOICES:
            raise ServeConfigError(f"quantize must be one of "
                                   f"{QUANTIZE_CHOICES}, got {self.quantize!r}")
        if self.kv_bits not in (None, 8, 16):
            raise ServeConfigError(f"kv_bits must be 8 or 16, "
                                   f"got {self.kv_bits!r}")
        if self.num_pages is not None and self.page_size is None:
            raise ServeConfigError("--num-pages needs --page-size")
        if self.max_queue is not None and self.max_queue < 1:
            raise ServeConfigError("--max-queue must be >= 1")
        if self.deadline is not None and self.deadline <= 0:
            raise ServeConfigError("--deadline must be > 0 engine ticks")
        if not self.prefix_reuse and self.page_size is None:
            raise ServeConfigError("--no-prefix-reuse needs --page-size")
        if self.serve_async and not self.trace:
            raise ServeConfigError(
                "--serve-async needs --trace N (open-loop arrivals)")
        if self.serve_async and self.qps <= 0:
            raise ServeConfigError("--qps must be > 0 requests/tick")
        if self.serve_async and self.retry_attempts < 1:
            raise ServeConfigError("--retry-attempts must be >= 1")
        if not 0.0 < self.shed_pressure <= 1.0:
            raise ServeConfigError("--shed-pressure must be in (0, 1]")
        if (self.straggler_threshold is not None
                and self.straggler_threshold <= 1):
            raise ServeConfigError(
                "--straggler-threshold must be > 1 (a slowdown multiplier)")
        if self.trace and (self.prompt_min > self.prompt_len
                           or self.gen_min > self.gen_len):
            raise ServeConfigError("--prompt-min/--gen-min exceed "
                                   "--prompt-len/--gen-len")
        if self.mesh is not None:
            self.mesh = parse_mesh(self.mesh)     # tolerate a "2x4" string
            from .mesh import check_fits, mesh_backend

            try:
                check_fits(self.mesh, self.device,
                           mesh_backend(self.device, self.mesh_backend))
            except ValueError as e:
                raise ServeConfigError(f"--mesh {self.mesh_str}: {e}") from None
        return self

    @property
    def mesh_str(self) -> Optional[str]:
        return None if self.mesh is None else "x".join(map(str, self.mesh))

    @property
    def mesh_size(self) -> int:
        return 1 if self.mesh is None else math.prod(self.mesh)

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "ServeConfig":
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(ns, f.name)
            parse = f.metadata.get("parse")
            kw[f.name] = parse(v) if parse is not None else v
        return cls(**kw)

    @classmethod
    def from_artifact(cls, qm) -> "ServeConfig":
        """The ServeConfig a ``QuantizedModel`` was quantized AS: its arch
        (and smoke), its recipe, its weight scheme — the mode of its int8
        weights, or "none" for fp (fake-quantized) ones — its KV precision,
        and the mesh a sharded artifact recorded."""
        from ..quantized.qtensor import QTensor

        def modes(node):
            if isinstance(node, QTensor):
                return {node.mode}
            if isinstance(node, dict):
                return set().union(*map(modes, node.values()))
            return set()

        name = qm.cfg.name
        smoke = name.endswith("-smoke")
        found = modes(qm.params)
        sharding = getattr(qm, "sharding", {}) or {}
        mesh = (tuple(sharding["mesh_shape"])
                if sharding.get("mode") and sharding.get("mesh_shape")
                else None)
        return cls(arch=name[: -len("-smoke")] if smoke else name,
                   smoke=smoke, quantize=found.pop() if found else "none",
                   recipe=qm.recipe.name, kv_bits=qm.cfg.kv_cache_bits,
                   mesh=mesh)

    def with_artifact(self, art: "ServeConfig"):
        """Merge this (CLI/API) config with an artifact's record:
        ``_ARTIFACT_POLICY``'s fields are served as the artifact recorded
        them. Returns ``(merged, notes)``, a note for each explicit value
        that was ignored; a "must-match" conflict raises
        ``ServeConfigError``."""
        merged, notes = {}, []
        for name, policy in _ARTIFACT_POLICY.items():
            cli, rec = getattr(self, name), getattr(art, name)
            flag = "--" + name.replace("_", "-")
            if policy == "cli":
                # an explicit value re-deploys; else the artifact's
                merged[name] = rec if cli == _DEFAULTS[name] else cli
                if cli != _DEFAULTS[name] and rec is not None and rec != cli:
                    notes.append(f"{flag} {_fmt(cli)} overrides the "
                                 f"artifact-recorded {_fmt(rec)}")
                continue
            merged[name] = rec
            if cli == _DEFAULTS[name] or cli == rec:
                continue
            if policy == "must-match":
                raise ServeConfigError(
                    f"{flag} {cli} conflicts with the --load artifact: it "
                    f"recorded kv_cache_bits={rec}. Either drop {flag} to "
                    f"serve as recorded, or re-quantize the model for "
                    f"kv_cache_bits={cli}")
            notes.append(f"{flag} {cli} ignored: the artifact is served as "
                         f"saved ({name}={rec})")
        return dataclasses.replace(self, **merged), notes


#: how a --load artifact's record meets this config (the JAX launcher's
#: rule for the fields the port's config has): "cli" — serving honours
#: either, an explicit value wins (mesh: re-deploy on a new topology);
#: "baked" — the saved weights are this value, the artifact wins;
#: "must-match" — the calibration is bound to the recorded value, a
#: differing explicit one raises
_ARTIFACT_POLICY = {"mesh": "cli", "arch": "baked", "smoke": "baked",
                    "quantize": "baked", "recipe": "baked",
                    "kv_bits": "must-match"}
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ServeConfig)}


def _fmt(v) -> str:
    """A field's value as its flag takes it (a mesh as DxM)."""
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


def build_parser() -> argparse.ArgumentParser:
    """The ``python -m repro_torch.launch.serve`` flags, derived from the
    ServeConfig fields."""
    ap = argparse.ArgumentParser(
        description="quantize a model data-free (norm folding, CLE, bias "
                    "absorption, int8 pack) and serve it with the "
                    "continuous-batching engine on the card")
    for f in dataclasses.fields(ServeConfig):
        md = dict(f.metadata)
        md.pop("parse", None)
        help_ = md.pop("help", None)
        flag = md.pop("flag", "--" + f.name.replace("_", "-"))
        if md.pop("invert", False):
            ap.add_argument(flag, dest=f.name, action="store_false",
                            default=f.default, help=help_)
        elif md.pop("switch", False):
            ap.add_argument(flag, dest=f.name, action="store_true",
                            default=f.default, help=help_)
        else:
            ap.add_argument(flag, dest=f.name, default=f.default, help=help_,
                            **md)
    return ap
