"""Declarative recipes: named stage sequences with per-stage options (port
of ``repro.pipeline.recipes``).

A recipe is data, not code. The built-ins are the JAX package's: the
paper's Fig. 4 flow (``dfq-int8``) and its two ablations, and the serving
deployments — norm folding → CLE → bias absorption → int8 pack, with or
without the int8 KV cache — each with its tensor-parallel ``-tp`` twin
(the same stages and ``shard[tp]``, which records the plan).
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Iterable, Mapping, Sequence, Union

from .registry import get_stage, list_stages
from .state import RecipeError


@dataclasses.dataclass(frozen=True)
class RecipeStep:
    stage: str
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    steps: tuple
    description: str = ""

    def validate(self) -> None:
        """Fail fast with an actionable error before any compute runs."""
        if not self.steps:
            raise RecipeError(f"recipe {self.name!r} has no stages")
        problems = []
        for i, step in enumerate(self.steps):
            if not isinstance(step, RecipeStep):
                problems.append(
                    f"step {i} is {type(step).__name__}, not RecipeStep")
                continue
            try:
                stage = get_stage(step.stage)
            except RecipeError as e:
                problems.append(f"step {i}: {e}")
                continue
            if not isinstance(step.options, Mapping):
                problems.append(
                    f"step {i} ({step.stage!r}): options must be a mapping, "
                    f"got {type(step.options).__name__}")
                continue
            unknown = set(step.options) - stage.allowed_options
            if unknown:
                problems.append(
                    f"step {i} ({step.stage!r}): unknown option(s) "
                    f"{sorted(unknown)}; allowed: "
                    f"{sorted(stage.allowed_options) or '(none)'}")
        if problems:
            raise RecipeError(f"recipe {self.name!r} failed validation:\n  - "
                              + "\n  - ".join(problems))

    def with_options(self, overrides: Mapping[str, Mapping[str, Any]]) -> "Recipe":
        """Merge per-stage option overrides ({stage_name: {opt: val}})."""
        names = {s.stage for s in self.steps}
        unknown = set(overrides) - names
        if unknown:
            raise RecipeError(
                f"recipe {self.name!r} has no stage(s) {sorted(unknown)} to "
                f"override; stages: {sorted(names)}")
        steps = tuple(
            RecipeStep(s.stage, {**dict(s.options),
                                 **dict(overrides.get(s.stage, {}))})
            for s in self.steps)
        return dataclasses.replace(self, steps=steps)

    def stage_names(self) -> list:
        return [s.stage for s in self.steps]


def _r(name: str, description: str, *steps) -> Recipe:
    return Recipe(name, tuple(RecipeStep(s, {}) if isinstance(s, str)
                              else RecipeStep(*s) for s in steps),
                  description)


BUILTIN_RECIPES: dict = {
    r.name: r
    for r in (
        _r("dfq-int8",
           "The paper's Fig. 4 flow: fold → CLE → absorb → bias-correct → "
           "fake-quant INT8 (near-FP32 simulated inference)",
           "fold_norm", "cle", "bias_absorb",
           ("bias_correct", {"method": "empirical"}), "weight_quant"),
        _r("naive-int8",
           "Per-tensor INT8 round-to-nearest, no DFQ — the collapse baseline",
           "weight_quant"),
        _r("cle-only",
           "Equalization ablation: fold → CLE → fake-quant (no absorption, "
           "no bias correction)",
           "fold_norm", "cle", "weight_quant"),
        _r("serve-w8a16",
           "Deployment: fold → CLE → absorb → pack int8 weights "
           "(dequant-in-kernel matmul)",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a16"})),
        _r("serve-w8a8",
           "Deployment: fold → CLE → absorb → pack int8 weights with dynamic "
           "int8 activations (int8 tensor-core matmul)",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a8"})),
        _r("serve-w8a16-kv8",
           "serve-w8a16 plus an int8 KV cache (per-token/per-head scales; "
           "decode attends over it through the int8 attention kernels)",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a16"}),
           ("kv_cache", {"bits": 8})),
        _r("serve-w8a8-kv8",
           "serve-w8a8 plus an int8 KV cache — the full int8 serving stack "
           "(weights, activations, KV stream)",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a8"}),
           ("kv_cache", {"bits": 8})),
        # every serve-* deployment has a -tp twin (same stages + shard[tp])
        # so --mesh never has to drop the topology from a saved artifact
        _r("serve-w8a16-tp",
           "serve-w8a16 deployed tensor-parallel: int8 weights + scales "
           "co-sharded over the mesh's \"model\" axis, KV pool sharded "
           "slot-wise over \"data\"",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a16"}),
           ("shard", {"mode": "tp"})),
        _r("serve-w8a8-tp",
           "serve-w8a8 deployed tensor-parallel across a device mesh",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a8"}),
           ("shard", {"mode": "tp"})),
        _r("serve-w8a16-kv8-tp",
           "serve-w8a16-kv8 deployed tensor-parallel across a device mesh",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a16"}),
           ("kv_cache", {"bits": 8}), ("shard", {"mode": "tp"})),
        _r("serve-w8a8-kv8-tp",
           "the full int8 serving stack (weights, activations, KV stream) "
           "deployed tensor-parallel across a device mesh",
           "fold_norm", "cle", "bias_absorb", ("pack", {"mode": "w8a8"}),
           ("kv_cache", {"bits": 8}), ("shard", {"mode": "tp"})),
    )
}

RecipeLike = Union[str, Recipe, Sequence]


def resolve_recipe(spec: RecipeLike) -> Recipe:
    """str → built-in; Recipe → itself; a sequence of stage names /
    (name, options) pairs / RecipeSteps → an anonymous recipe."""
    if isinstance(spec, Recipe):
        return spec
    if isinstance(spec, str):
        if spec in BUILTIN_RECIPES:
            return BUILTIN_RECIPES[spec]
        hint = difflib.get_close_matches(spec, BUILTIN_RECIPES, n=1)
        suggest = f" — did you mean {hint[0]!r}?" if hint else ""
        raise RecipeError(
            f"unknown recipe {spec!r}{suggest} Built-ins: "
            f"{', '.join(sorted(BUILTIN_RECIPES))}. A custom recipe is a "
            "Recipe instance or a list of stage names from: "
            f"{', '.join(list_stages())}")
    if isinstance(spec, Iterable):
        steps = []
        for s in spec:
            if isinstance(s, RecipeStep):
                steps.append(s)
            elif isinstance(s, str):
                steps.append(RecipeStep(s, {}))
            elif isinstance(s, (tuple, list)) and len(s) == 2:
                steps.append(RecipeStep(s[0], dict(s[1])))
            else:
                raise RecipeError(
                    f"cannot interpret recipe step {s!r}; use a stage name, "
                    "a (name, options) pair, or a RecipeStep")
        return Recipe("custom", tuple(steps), "ad-hoc recipe")
    raise RecipeError(
        f"cannot interpret recipe spec of type {type(spec).__name__}; pass a "
        "built-in name, a Recipe, or a list of stages")


def list_recipes() -> list:
    return sorted(BUILTIN_RECIPES)


def split_recipe_flags(name: str) -> tuple:
    """``"serve-w8a8-kv8-tp+paged"`` → ``("serve-w8a8-kv8-tp", ("paged",))``.

    Recipe *flags* (``+flag`` suffixes) select a serving-engine geometry
    variant — they are NOT pipeline stages, so the base name is what
    ``resolve_recipe`` sees. Known flags: ``paged`` (page-table KV pool).
    Unknown flags raise RecipeError so a typo can't silently lint the
    contiguous geometry under a paged contract stem."""
    base, _, rest = name.partition("+")
    flags = tuple(f for f in rest.split("+") if f) if rest else ()
    for f in flags:
        if f != "paged":
            raise RecipeError(
                f"unknown recipe flag {f!r} in {name!r} (known: 'paged')"
            )
    return base, flags


def lint_mesh_shape(recipe_name: str):
    """The mesh shape the graph linter checks a recipe under: the
    reference topology (2 data x 4 model) for ``-tp`` recipes,
    single-device otherwise. Recipe flags (``+paged``) don't change the
    topology."""
    base, _ = split_recipe_flags(recipe_name)
    return (2, 4) if base.endswith("-tp") else None


def contract_stem(recipe_name: str, mesh_shape=None) -> str:
    """Filename stem of a recipe's lint contract:
    ``<recipe>`` single-device, ``<recipe>.<DxM>`` under a mesh — so the
    same recipe can pin contracts for several topologies side by side.
    Recipe flags come AFTER the mesh suffix (``serve-w8a8-kv8-tp.2x4+paged``)
    so a recipe's contract family sorts together."""
    base, flags = split_recipe_flags(recipe_name)
    resolve_recipe(base)  # fail fast (with did-you-mean) on typos
    stem = base
    if mesh_shape:
        stem = f"{base}.{'x'.join(str(int(s)) for s in mesh_shape)}"
    return stem + "".join(f"+{f}" for f in flags)
