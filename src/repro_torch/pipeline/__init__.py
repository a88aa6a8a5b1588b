"""Quantization pipeline: stage registry + recipes + QuantizedModel (port
of ``repro.pipeline``, the stages the ``serve-*`` recipes need).

    repro_torch.quantize(arch_or_model, params=None, recipe=..., ...)
        → QuantizedModel (.params, .report, .site_sqnr_db(), ...)

    Recipe / resolve_recipe / list_recipes — declarative stage sequences
    register_stage / list_stages — pluggable stage registry
"""
from .state import (  # noqa: F401
    PipelineContext,
    PipelineError,
    PipelineState,
    RecipeError,
    StageRecord,
)
from .registry import (  # noqa: F401
    NOT_PORTED,
    Stage,
    get_stage,
    list_stages,
    register_stage,
    unregister_stage,
)
from . import stages  # noqa: F401  (registers the built-in stages)
from .recipes import (  # noqa: F401
    BUILTIN_RECIPES,
    Recipe,
    RecipeStep,
    list_recipes,
    resolve_recipe,
)
from .artifact import QuantizedModel  # noqa: F401
from .api import quantize, run_recipe  # noqa: F401
