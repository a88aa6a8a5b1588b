"""Typed serving configuration: one dataclass is both the ``serve`` API and
(through ``build_parser``) the CLI, as in ``repro.launch.serve_config``. Only
the knobs of the port's serving path so far: the fast path (default, with
``decode_horizon``) or the stepwise ``reference``, ``warmup``, ``load``
(serve a saved ``QuantizedModel``), and one the JAX launcher lacks:
``layers`` (the arch cut to its first N layers, widths kept, for a card
that cannot hold the full depth). The kernel tier is the device's unless
``REPRO_KERNEL_BACKEND`` names one (``kernels.dispatch``).

``quantize`` picks the weight scheme (``w8a16``, the JAX launcher's default,
``w8a8``, or ``none``: the fp32 weights, unquantized) and ``kv_bits`` the
KV-cache precision (8: int8; 16: fp; None: what the recipe or artifact
recorded — the fp cache unless a ``kv_cache`` stage said 8), with the JAX
launcher's recipe choice: ``serve-<quantize>-kv8`` for ``kv_bits=8``, else
``serve-<quantize>``. The default deployment is therefore the reference's:
W8A16 weights over a bf16 KV cache.

With ``load``, the artifact's record meets this config under the JAX
launcher's precedence contract (``repro.launch.serve_config.
_ARTIFACT_POLICY``) as far as it concerns fields this config has: ``arch``,
``smoke`` and ``quantize`` are "baked" — the artifact is served as saved and
an explicit differing value is reported as ignored — and ``kv_bits`` is
"must-match": an explicit value other than the artifact's raises.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


#: the weight schemes the launcher serves ("none": fp32 weights)
QUANTIZE_CHOICES = ("none", "w8a16", "w8a8")


class ServeConfigError(ValueError):
    """Invalid serving configuration."""


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
    kv_bits: Optional[int] = _f(
        None, "KV-cache precision: 8 = int8 payload + per-token/per-head "
        "scales (decode attends through the fused_decode kernel), 16 = fp. "
        "Default: what the recipe/artifact recorded (--kv-bits 8 selects "
        "the serve-<quantize>-kv8 recipe)", type=int, choices=[8, 16])
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
        (and smoke), its weight scheme — the mode of its int8 weights, or
        "none" for fp (fake-quantized) ones — and its KV precision."""
        from ..quantized.qtensor import QTensor

        name = qm.cfg.name
        smoke = name.endswith("-smoke")
        modes = {w.mode for w in qm.params["blocks"]["attn"].values()
                 if isinstance(w, QTensor)}
        return cls(arch=name[: -len("-smoke")] if smoke else name,
                   smoke=smoke, quantize=modes.pop() if modes else "none",
                   kv_bits=qm.cfg.kv_cache_bits)

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
#: rule for the fields the port's config has): "baked" — the saved weights
#: are this value, the artifact wins; "must-match" — the calibration is
#: bound to the recorded value, a differing explicit one raises
_ARTIFACT_POLICY = {"arch": "baked", "smoke": "baked", "quantize": "baked",
                    "kv_bits": "must-match"}
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
    return ap
