"""Quantization pipeline: stage registry + recipes + QuantizedModel (port
of ``repro.pipeline``).

    repro_torch.quantize(arch_or_model, params=None, recipe="dfq-int8", ...)
        → QuantizedModel (.apply/.prefill/.decode_step, .save/.load,
          .report, .site_sqnr_db(), ...)

    Recipe / resolve_recipe / list_recipes — declarative stage sequences
    register_stage / list_stages — pluggable stage registry
    python -m repro_torch.pipeline.cli — command-line front-end
"""
from .state import (  # noqa: F401
    PipelineContext,
    PipelineError,
    PipelineState,
    RecipeError,
    StageRecord,
)
from .registry import (  # noqa: F401
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
from .api import default_calibration, quantize, run_recipe  # noqa: F401
