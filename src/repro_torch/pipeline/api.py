"""The one-call quantization API the paper promises (§1) — port of
``repro.pipeline.api``.

    import repro_torch
    qm = repro_torch.quantize("qwen2-0.5b")                   # dfq-int8
    qm = repro_torch.quantize("qwen2-0.5b", recipe="serve-w8a16-kv8")
    run = repro_torch.ServingEngine(qm.model, qm.params, qm.cfg).run(reqs)

``quantize`` resolves the architecture, runs the recipe's stages over a
``PipelineState`` on the card (or on the CPU when the caller passes
``device="cpu"``), and returns a ``QuantizedModel``. The default recipe is
the JAX package's, the paper's ``dfq-int8`` flow; its bias correction reads
E[x] from the default calibration hook, synthetic random tokens through
``LMModel.calibration_stats`` (data-free), built here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Optional, Union

import torch

from ..core.dfq import DFQConfig
from ..device import resolve_device
from ..models.config import ModelConfig
from ..quantized.qtensor import map_leaves
from .artifact import QuantizedModel
from .recipes import Recipe, RecipeLike, RecipeStep, resolve_recipe
from .registry import get_stage
from .state import (
    PipelineContext,
    PipelineError,
    PipelineState,
    StageRecord,
)

# weight_quant stage option → DFQConfig field. The quant spec must be ONE
# truth for the whole recipe: bias_correct computes ε = fq(W) − W from the
# config's spec, so a quantizer choice that stayed stage-local would make
# the correction target a quantizer that never runs.
_WEIGHT_SPEC_OPTS = {"bits": "weight_bits", "per_channel": "per_channel",
                     "symmetric": "weight_symmetric"}


def _fold_weight_spec_overrides(recipe: Recipe, config: DFQConfig) -> DFQConfig:
    repl = {}
    for step in recipe.steps:
        if step.stage == "weight_quant":
            for opt, field in _WEIGHT_SPEC_OPTS.items():
                if step.options.get(opt) is not None:
                    repl[field] = step.options[opt]
        elif step.stage == "pack":
            # the pack quantizer is symmetric int8 absmax (per-channel
            # optional): mirror it into the config's spec so that a
            # bias_correct in the same recipe computes ε against the
            # quantizer that ships
            repl["weight_bits"] = 8
            repl["weight_symmetric"] = True
            repl["per_channel"] = bool(step.options.get("per_channel", False))
    return dataclasses.replace(config, **repl) if repl else config


def run_recipe(recipe: Recipe, state: PipelineState,
               ctx: PipelineContext) -> PipelineState:
    """Validate, then execute a recipe's stages, timing each into the
    report."""
    recipe.validate()
    state.config = _fold_weight_spec_overrides(recipe, state.config)
    for step in recipe.steps:
        stage = get_stage(step.stage)
        t0 = time.perf_counter()
        state = stage.run(state, ctx, step.options)
        if not isinstance(state, PipelineState):
            raise PipelineError(
                f"stage {step.stage!r} returned {type(state).__name__}, not "
                "PipelineState — stages must return the (updated) state")
        state.records.append(StageRecord(
            stage=step.stage, options=dict(step.options),
            seconds=time.perf_counter() - t0, metrics=state.pop_metrics()))
    return state


def default_calibration(model, cfg: ModelConfig, *, seed: int = 1,
                        batch: int = 2, seq: int = 32
                        ) -> Callable[[Mapping], Mapping]:
    """The standard data-free calibration hook: synthetic random tokens
    (``data.calibration_tokens``, on the device of the params it is given),
    plus random frames for an encoder-decoder (``prng.normal`` under
    ``PRNGKey(seed)``, the reference's ``jax.random.normal`` draw within 4
    ulp), through ``model.calibration_stats``."""
    from ..data import calibration_tokens, prng

    def calibrate(params):
        device = params["embed"].device
        toks = calibration_tokens(seed, batch, seq, cfg.vocab_size,
                                  device=device)
        if cfg.is_encdec:
            frames = prng.normal(prng.PRNGKey(seed),
                                 (batch, cfg.enc_seq, cfg.d_model))
            return model.calibration_stats(
                params, toks, torch.from_numpy(frames).to(device))
        return model.calibration_stats(params, toks)

    return calibrate


def _resolve_model(arch_or_model) -> tuple:
    from ..models import build_model

    if isinstance(arch_or_model, str):
        from ..configs import get_config

        cfg = get_config(arch_or_model)
        return build_model(cfg), cfg
    if isinstance(arch_or_model, ModelConfig):
        return build_model(arch_or_model), arch_or_model
    cfg = getattr(arch_or_model, "cfg", None)
    if cfg is not None and hasattr(arch_or_model, "dfq_plan"):
        return arch_or_model, cfg
    raise PipelineError(
        f"cannot resolve a model from {type(arch_or_model).__name__}; pass an "
        "arch name (e.g. 'qwen2-0.5b-smoke'), a ModelConfig, or a model "
        "exposing .cfg and .dfq_plan()")


def quantize(
    arch_or_model: Union[str, ModelConfig, Any],
    params: Optional[Mapping] = None,
    recipe: RecipeLike = "dfq-int8",
    *,
    config: Optional[DFQConfig] = None,
    calibration: Union[str, Callable, None] = "auto",
    stage_options: Optional[Mapping[str, Mapping]] = None,
    init_seed: int = 0,
    calib_seed: int = 1,
    calib_batch: int = 2,
    calib_seq: int = 32,
    device: Optional[Union[str, torch.device]] = "cuda",
) -> QuantizedModel:
    """Quantize a model with a named (or custom) recipe.

    arch_or_model: arch name ("qwen2-0.5b", "-smoke" suffix honored), a
        ModelConfig, or a built model.
    params: existing parameters (moved to ``device``); None → the model's
        seeded ``init(init_seed)`` on ``device``.
    recipe: a built-in name (``dfq-int8``, the default; ``naive-int8``,
        ``cle-only``, ``serve-w8a16-kv8``, ...), a ``Recipe``, or a list of
        stage names / (name, options) pairs.
    config: ``DFQConfig`` defaults for every stage (bits, n-sigma, ...).
    calibration: "auto" → the synthetic-token hook (``default_calibration``
        with ``calib_seed`` / ``calib_batch`` / ``calib_seq``; run only by
        the stages that need E[x]); a callable ``params -> {stat_key:
        E[x]}``; or None to disable.
    stage_options: per-stage overrides, e.g. {"pack": {"per_channel": True}}.
    device: where the stages run — the card unless the caller asks for the
        CPU.
    """
    model, cfg = _resolve_model(arch_or_model)
    r = resolve_recipe(recipe)
    if stage_options:
        r = r.with_options(stage_options)
    r.validate()
    device = resolve_device(device)
    if params is None:
        params = model.init(init_seed, device=device)
    else:
        params = map_leaves(lambda t: t.to(device), params)
    if calibration == "auto":
        calibrate = default_calibration(model, cfg, seed=calib_seed,
                                        batch=calib_batch, seq=calib_seq)
    elif calibration is None or callable(calibration):
        calibrate = calibration
    else:
        raise PipelineError(f"calibration must be 'auto', a callable, or "
                            f"None; got {calibration!r}")
    state = PipelineState(params=params, plan=model.dfq_plan(),
                          config=config or DFQConfig())
    # the state holds the tree from here: a stage's replaced leaves are
    # freed as it returns (unless the caller holds the tree it passed)
    del params
    state = run_recipe(r, state, PipelineContext(model=model, cfg=cfg,
                                                 calibrate=calibrate))
    if state.kv_bits is not None and state.kv_bits != cfg.kv_cache_bits:
        # the kv_cache stage is weight-free: fold the KV precision into the
        # artifact's config (and rebuild the model over it) so init_cache,
        # the serving engine and save / load all see it, as the JAX package
        import dataclasses

        from ..models import build_model

        cfg = dataclasses.replace(cfg, kv_cache_bits=state.kv_bits)
        model = build_model(cfg)
    return QuantizedModel(model=model, cfg=cfg, params=state.params,
                          recipe=r, report=state.report,
                          act_qparams=state.act_qparams,
                          sharding=({"mode": state.shard_mode}
                                    if state.shard_mode else {}))


def run_legacy_dfq(params, plan, config: DFQConfig, input_means_fn) -> dict:
    """Backend of ``repro_torch.core.dfq_quantize``: the ``dfq-int8`` recipe
    with the config's stage switches applied, returning bare
    fake-quantized params."""
    steps = [RecipeStep("fold_norm", {})]
    if config.cle:
        steps.append(RecipeStep("cle", {}))
    if config.bias_absorb:
        steps.append(RecipeStep("bias_absorb", {}))
    if config.bias_correct != "none" and input_means_fn is not None:
        steps.append(RecipeStep("bias_correct", {"method": "empirical"}))
    steps.append(RecipeStep("weight_quant", {}))
    recipe = Recipe("dfq-int8/legacy", tuple(steps),
                    "dfq_quantize compatibility")
    state = run_recipe(recipe,
                       PipelineState(params=params, plan=plan, config=config),
                       PipelineContext(calibrate=input_means_fn))
    return state.params
