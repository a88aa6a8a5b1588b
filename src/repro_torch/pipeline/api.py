"""The one-call quantization API the paper promises (§1) — port of
``repro.pipeline.api``.

    import repro_torch
    qm = repro_torch.quantize("qwen2-0.5b", recipe="serve-w8a16-kv8")
    run = repro_torch.ServingEngine(qm.model, qm.params, qm.cfg).run(reqs)

``quantize`` resolves the architecture, runs the recipe's stages over a
``PipelineState`` on the card (or on the CPU when the caller passes
``device="cpu"``), and returns a ``QuantizedModel``. The recipe has no
default: the JAX package's default, the paper's ``dfq-int8`` flow, needs
bias correction, a later slice of the port.
"""
from __future__ import annotations

import time
from typing import Any, Mapping, Optional, Union

import torch

from ..core.dfq import DFQConfig
from ..device import resolve_device
from ..models.config import ModelConfig
from ..quantized.qtensor import map_leaves
from .artifact import QuantizedModel
from .recipes import BUILTIN_RECIPES, Recipe, RecipeLike, resolve_recipe
from .registry import get_stage
from .state import (
    PipelineContext,
    PipelineError,
    PipelineState,
    StageRecord,
)


def run_recipe(recipe: Recipe, state: PipelineState,
               ctx: PipelineContext) -> PipelineState:
    """Validate, then execute a recipe's stages, timing each into the
    report."""
    recipe.validate()
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
    recipe: Optional[RecipeLike] = None,
    *,
    config: Optional[DFQConfig] = None,
    stage_options: Optional[Mapping[str, Mapping]] = None,
    init_seed: int = 0,
    device: Optional[Union[str, torch.device]] = "cuda",
) -> QuantizedModel:
    """Quantize a model with a named (or custom) recipe.

    arch_or_model: arch name ("qwen2-0.5b", "-smoke" suffix honored), a
        ModelConfig, or a built model.
    params: existing parameters (moved to ``device``); None → the model's
        seeded ``init(init_seed)`` on ``device``.
    recipe: a built-in name (``serve-w8a16-kv8``, ``serve-w8a8-kv8``, ...),
        a ``Recipe``, or a list of stage names / (name, options) pairs.
    config: ``DFQConfig``, the rewrites' switches (the cle stage's
        default iteration count).
    stage_options: per-stage overrides, e.g. {"pack": {"per_channel": True}}.
    device: where the stages run — the card unless the caller asks for the
        CPU.
    """
    if recipe is None:
        raise PipelineError(
            f"quantize needs a recipe; the port's built-ins are "
            f"{', '.join(sorted(BUILTIN_RECIPES))} (the paper's dfq-int8 "
            "flow is not ported yet)")
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
    state = PipelineState(params=params, plan=model.dfq_plan(),
                          config=config or DFQConfig())
    state = run_recipe(r, state, PipelineContext(model=model, cfg=cfg))
    return QuantizedModel(model=model, cfg=cfg, params=state.params,
                          recipe=r, report=state.report,
                          kv_bits=state.kv_bits)
