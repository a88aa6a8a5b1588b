"""Stage registry: named, pluggable pipeline transforms (port of
``repro.pipeline.registry``).

The built-in stages (``stages.py``) wrap the core DFQ transforms; other
code registers more with ``@register_stage(name, **option_defaults)``. The
declared keyword defaults double as the stage's option schema: a recipe
passing an undeclared option fails validation with an actionable error.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, Mapping

from .state import PipelineError, RecipeError

_STAGES: dict = {}


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    fn: Callable
    defaults: Mapping[str, Any]
    doc: str = ""

    @property
    def allowed_options(self) -> frozenset:
        return frozenset(self.defaults)

    def run(self, state, ctx, options: Mapping[str, Any]):
        unknown = set(options) - self.allowed_options
        if unknown:
            raise RecipeError(
                f"stage {self.name!r} got unknown option(s) {sorted(unknown)}; "
                f"allowed: {sorted(self.allowed_options) or '(none)'}")
        return self.fn(state, ctx, **{**self.defaults, **options})


def register_stage(name: str, **defaults):
    """Decorator: register ``fn(state, ctx, **options)`` under ``name``;
    ``defaults`` declares every option the stage accepts."""

    def deco(fn):
        if name in _STAGES:
            prev = _STAGES[name].fn
            raise PipelineError(
                f"stage {name!r} is already registered (by "
                f"{prev.__module__}.{prev.__qualname__}); unregister_stage() "
                "first to replace it")
        _STAGES[name] = Stage(name, fn, dict(defaults),
                              doc=(fn.__doc__ or "").strip())
        return fn

    return deco


def unregister_stage(name: str) -> None:
    _STAGES.pop(name, None)


def get_stage(name: str) -> Stage:
    try:
        return _STAGES[name]
    except KeyError:
        pass
    hint = difflib.get_close_matches(name, list(_STAGES), n=1)
    suggest = f" — did you mean {hint[0]!r}?" if hint else ""
    raise RecipeError(f"unknown stage {name!r}{suggest} Registered stages: "
                      f"{', '.join(sorted(_STAGES))}") from None


def list_stages() -> list:
    return sorted(_STAGES)
