"""Typed serving configuration: one dataclass is both the ``serve`` API and
(through ``build_parser``) the CLI, as in ``repro.launch.serve_config``. Only
the knobs of the port's serving path so far: the fast path (default, with
``decode_horizon``) or the stepwise ``reference``, ``warmup``, and ``load``
(serve a saved ``QuantizedModel``).

``quantize`` picks the weight scheme (``w8a16``, the JAX launcher's default,
or ``w8a8``); the port serves an int8 KV cache only, so the KV precision is
a constant here, not a field: the CLI still takes ``--kv-bits 8`` as the
JAX launcher does, and refuses any other value.

With ``load``, the artifact's record wins, under the JAX launcher's
precedence contract (``repro.launch.serve_config._ARTIFACT_POLICY``) as far
as it concerns fields this config has: ``arch``, ``smoke`` and ``quantize``
are "baked" — the artifact is served as saved and an explicit differing
value is reported as ignored — and the KV precision is the artifact's, which
must be the int8 cache.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


#: the weight schemes the port serves (the JAX launcher also has "none")
QUANTIZE_CHOICES = ("w8a16", "w8a8")
#: the one KV-cache precision ported so far
KV_BITS = 8


class ServeConfigError(ValueError):
    """Invalid serving configuration."""


def _f(default, help=None, **cli):
    return dataclasses.field(default=default, metadata={"help": help, **cli})


@dataclasses.dataclass
class ServeConfig:
    arch: str = _f("qwen2-0.5b", "architecture id (see configs.registry)")
    smoke: bool = _f(False, "use the arch's smoke-sized config", switch=True)
    seed: int = _f(0, "seed of the random weights", type=int)
    quantize: str = _f("w8a16", "weight/activation scheme: int8 weights "
                       "with fp activations (w8a16) or with dynamic int8 "
                       "activations (w8a8); serves the serve-<scheme>-kv8 "
                       "recipe", choices=list(QUANTIZE_CHOICES))
    device: str = _f("cuda", "cuda (default) or cpu (the plain PyTorch "
                     "versions of the kernels)")
    slots: int = _f(4, "engine cache-pool size (decode batch width)", type=int)
    max_len: Optional[int] = _f(
        None, "per-slot KV capacity (default: fits prompt+gen)", type=int)
    prefill_chunk: int = _f(16, None, type=int)
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
    prompt_min: int = _f(4, "shortest prompt", type=int)
    gen_min: int = _f(4, "fewest new tokens", type=int)
    trace: int = _f(4, "serve a synthetic arrival schedule of N requests "
                    "(log-uniform lengths, Poisson arrivals)", type=int,
                    metavar="N")
    trace_seed: int = _f(0, None, type=int)
    profile: bool = _f(False, "trace the serving loop with torch.profiler and "
                       "print device time by kernel and the device busy "
                       "share", switch=True)
    load: Optional[str] = _f(
        None, "serve a saved QuantizedModel (skips quantization; its arch, "
        "weight scheme and KV precision are the artifact's)", metavar="DIR")

    def validate(self) -> "ServeConfig":
        for name in ("slots", "prefill_chunk", "decode_horizon", "trace",
                     "prompt_len", "gen_len", "prompt_min", "gen_min"):
            if getattr(self, name) < 1:
                raise ServeConfigError(f"{name} must be >= 1")
        if self.quantize not in QUANTIZE_CHOICES:
            raise ServeConfigError(f"quantize must be one of "
                                   f"{QUANTIZE_CHOICES}, got {self.quantize!r}")
        if self.prompt_min > self.prompt_len or self.gen_min > self.gen_len:
            raise ServeConfigError("--prompt-min/--gen-min exceed "
                                   "--prompt-len/--gen-len")
        return self

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "ServeConfig":
        return cls(**{f.name: getattr(ns, f.name)
                      for f in dataclasses.fields(cls)})

    @classmethod
    def from_artifact(cls, qm) -> "ServeConfig":
        """The ServeConfig a ``QuantizedModel`` was quantized AS: its arch
        (and smoke), and its weight scheme — the mode of its int8 weights,
        or "none" for fp (fake-quantized) ones."""
        from ..quantized.qtensor import QTensor

        name = qm.cfg.name
        smoke = name.endswith("-smoke")
        modes = {w.mode for w in qm.params["blocks"]["attn"].values()
                 if isinstance(w, QTensor)}
        return cls(arch=name[: -len("-smoke")] if smoke else name,
                   smoke=smoke, quantize=modes.pop() if modes else "none")

    def with_artifact(self, art: "ServeConfig"):
        """Merge this (CLI/API) config with an artifact's record:
        ``_ARTIFACT_POLICY``'s fields are served as the artifact recorded
        them. Returns ``(merged, notes)``, a note for each explicit value
        that was ignored."""
        merged, notes = {}, []
        for name in _ARTIFACT_POLICY:
            cli, rec = getattr(self, name), getattr(art, name)
            merged[name] = rec
            if cli != _DEFAULTS[name] and cli != rec:
                notes.append(f"--{name.replace('_', '-')} {cli} ignored: the "
                             f"artifact is served as saved ({name}={rec})")
        return dataclasses.replace(self, **merged), notes


#: how a --load artifact's record meets this config (the JAX launcher's
#: "baked" fields that the port's config has): the artifact wins
_ARTIFACT_POLICY = ("arch", "smoke", "quantize")
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ServeConfig)}


def build_parser() -> argparse.ArgumentParser:
    """The ``python -m repro_torch.launch.serve`` flags, derived from the
    ServeConfig fields."""
    ap = argparse.ArgumentParser(
        description="quantize a model data-free (norm folding, CLE, bias "
                    "absorption, int8 pack) and serve it with the "
                    "continuous-batching engine on the card")
    for f in dataclasses.fields(ServeConfig):
        md = dict(f.metadata)
        help_ = md.pop("help", None)
        flag = "--" + f.name.replace("_", "-")
        if md.pop("switch", False):
            ap.add_argument(flag, dest=f.name, action="store_true",
                            default=f.default, help=help_)
        else:
            ap.add_argument(flag, dest=f.name, default=f.default, help=help_,
                            **md)
    ap.add_argument("--kv-bits", default=KV_BITS, type=int, choices=[KV_BITS],
                    help="KV-cache precision (the int8 cache is the one "
                         "ported)")
    return ap
