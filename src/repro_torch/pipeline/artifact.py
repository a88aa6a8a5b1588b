"""QuantizedModel: the deployable output of the quantization pipeline (port
of ``repro.pipeline.artifact``).

Bundles the model, its (fake-quantized or int8-packed) params, the recipe
and the per-stage report, and serves through the same prefill / decode
path as fp params (``QTensor`` dispatch in ``models.layers.linear``).
``save`` / ``load`` write and read the JAX package's artifact layout — the
checkpointer's ``step_0/`` (QTensors encoded as ``{"__qtensor_<mode>__":
{"q", "scale"}}`` dicts, ``q`` in its logical [..., K, N] layout) and the
``quantized_model.json`` sidecar — so an artifact saved by either package
loads in the other.

The config sidecar (hazard read off the reference): the JAX
``ModelConfig`` has a few more fields than the port's. ``load`` takes the
fields the port has — the MoE, SSM, hybrid and encoder-decoder fields
among them, so either package's mamba2, zamba2 or whisper artifact loads —
ignores those that do not change what the model computes (a cost-probe
switch, an init-only bias slot), and refuses any other whose value
differs from the JAX default (an MLP bias). The sidecar's ``sharding``
record — the shard stage's plan, and after ``save(directory, mesh=)`` the
mesh's shape and axes and every leaf's serve-mode spec as JAX prints it —
round-trips either way, so a JAX ``-tp`` artifact loads here and the
port's in JAX. ``kv_cache_bits`` is
a field of both configs — 8 after a ``kv_cache`` stage with bits=8, else
16 (the fp cache) — so either package's ``load`` serves the precision the
other saved; ``QuantizedModel.kv_bits`` reads it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Union

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..quantized.qtensor import QTensor
from .recipes import Recipe, RecipeStep
from .state import PipelineError

_META_FILE = "quantized_model.json"
_QT_PREFIX = "__qtensor_"

# JAX ModelConfig fields with no effect on what the model computes
# (a cost-probe switch, an init-only bias slot)
_IGNORED = frozenset({"attn_out_bias", "unroll_layers"})
_PORT_FIELDS = frozenset(f.name for f in dataclasses.fields(ModelConfig))


def _config_from_sidecar(fields: dict) -> ModelConfig:
    """The port's ``ModelConfig`` from an artifact's ``config`` record."""
    unknown = sorted(set(fields) - _PORT_FIELDS - _IGNORED)
    if unknown:
        raise PipelineError(
            f"the artifact's config has fields the port does not know: "
            f"{', '.join(unknown)}")
    return ModelConfig(**{k: v for k, v in fields.items() if k in _PORT_FIELDS})


def read_sharding(directory: str) -> dict:
    """An artifact's ``sharding`` record, read from its sidecar alone (no
    weights)."""
    meta_path = os.path.join(directory, _META_FILE)
    if not os.path.exists(meta_path):
        raise PipelineError(
            f"{directory!r} is not a QuantizedModel directory "
            f"(missing {_META_FILE}); save one with QuantizedModel.save()")
    with open(meta_path) as f:
        return json.load(f).get("sharding", {})


def _encode_qtensors(tree):
    """QTensor leaves → tagged plain dicts (the mode in the key; inside,
    ``q`` sorts before ``scale``, the order of their ``arr_i``)."""
    if isinstance(tree, QTensor):
        return {f"{_QT_PREFIX}{tree.mode}__": {"q": tree.q,
                                                "scale": tree.scale}}
    if isinstance(tree, dict):
        return {k: _encode_qtensors(v) for k, v in tree.items()}
    return tree


def _decode_qtensors(tree):
    if isinstance(tree, dict):
        if len(tree) == 1:
            key = next(iter(tree))
            if key.startswith(_QT_PREFIX) and key.endswith("__"):
                inner = tree[key]
                return QTensor(inner["q"], inner["scale"],
                               key[len(_QT_PREFIX):-2])
        return {k: _decode_qtensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode_qtensors(v) for v in tree]
    return tree


@dataclasses.dataclass
class QuantizedModel:
    """model + quantized params + recipe provenance + stage report."""

    model: Any
    cfg: ModelConfig
    params: Any
    recipe: Recipe
    report: list              # StageRecord.to_dict() per executed stage
    # {stat_key: QParams} from the act_ranges stage, for static-activation
    # backends; in memory only (save persists the float ranges in the
    # report, as the JAX package does)
    act_qparams: dict = dataclasses.field(default_factory=dict)
    # the serving parallelism plan from the shard stage: {"mode": "tp"} plus,
    # once save(mesh=...) ran, the mesh's shape and axes and the per-leaf
    # serve-mode specs ("/blocks/mlp/wu/q": "PartitionSpec(None, None,
    # 'model')"); round-trips through save / load
    sharding: dict = dataclasses.field(default_factory=dict)

    @property
    def shard_mode(self):
        """"tp" when the recipe carried a shard stage, else None."""
        return self.sharding.get("mode")

    def serve_pspecs(self, mesh) -> Any:
        """The serve-mode spec tree of this artifact's params over ``mesh``
        (int8 payload and scale co-sharded on "model", no FSDP)."""
        from ..sharding import params_pspecs

        heads = {"n_q": self.cfg.n_heads, "n_kv": self.cfg.n_kv_heads}
        return params_pspecs(self.params, mesh, heads, mode="serve")

    @property
    def kv_bits(self) -> int:
        """The serving KV precision: 8 after a ``kv_cache`` stage with
        bits=8, else 16 (the fp cache)."""
        return self.cfg.kv_cache_bits

    # ----------------------------------------------------------- inference
    def apply(self, tokens, **kwargs):
        return self.model.apply(self.params, tokens, **kwargs)

    def init_cache(self, batch: int, seq_len: int, **kwargs):
        return self.model.init_cache(batch, seq_len, **kwargs)

    def prefill(self, tokens, cache, **kwargs):
        return self.model.prefill(self.params, tokens, cache, **kwargs)

    def decode_step(self, token, cache):
        return self.model.decode_step(self.params, token, cache)

    # --------------------------------------------------------- diagnostics
    def serving_summary(self) -> dict:
        """Bytes accounting: fp vs int8 parameter payload."""
        from ..quantized.ptq import serving_summary

        return serving_summary(self.params)

    def stage_record(self, stage: str) -> Optional[dict]:
        """The last report record of ``stage`` (None if it did not run)."""
        for rec in reversed(self.report):
            if rec["stage"] == stage:
                return rec
        return None

    def site_sqnr_db(self) -> dict:
        """Per-site weight SQNR (dB) from the quantizing stage (pack or
        weight_quant)."""
        for name in ("pack", "weight_quant"):
            rec = self.stage_record(name)
            if rec and "sqnr_db" in rec.get("metrics", {}):
                return dict(rec["metrics"]["sqnr_db"])
        return {}

    # --------------------------------------------------------- persistence
    def save(self, directory: str, mesh=None) -> str:
        """Atomic save: the params through the checkpointer, then the JSON
        sidecar with the config, the recipe, the sharding record and the
        stage report. For a sharded artifact (a shard stage in the recipe),
        the deployment ``mesh`` (a ``DeviceMesh``, or anything whose
        ``shape`` maps axis → size) is recorded too: its shape, its axes and
        the serve-mode spec of every leaf."""
        from ..checkpoint import Checkpointer
        from ..sharding.partition import mesh_sizes, spec_paths

        Checkpointer(directory, keep=1).save(0, _encode_qtensors(self.params),
                                             blocking=True)
        sharding = dict(self.sharding)
        if mesh is not None and self.shard_mode:
            sizes = mesh_sizes(mesh)
            sharding.update(
                mesh_shape=[int(n) for n in sizes.values()],
                mesh_axes=list(sizes),
                specs={path: str(spec) for path, spec in
                       spec_paths(self.serve_pspecs(mesh))})
            self.sharding = sharding
        config = dataclasses.asdict(self.cfg)
        meta = {
            "format_version": 1,
            "config": config,
            "recipe": {"name": self.recipe.name,
                       "description": self.recipe.description,
                       "steps": [{"stage": s.stage, "options": dict(s.options)}
                                 for s in self.recipe.steps]},
            "sharding": sharding,
            "report": self.report,
        }
        tmp = os.path.join(directory, _META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, default=float)
        os.replace(tmp, os.path.join(directory, _META_FILE))
        return directory

    @classmethod
    def load(cls, directory: str, *,
             device: Optional[Union[str, torch.device]] = "cuda"
             ) -> "QuantizedModel":
        """Load an artifact saved by either package onto ``device`` (the
        card unless the caller asks for the CPU)."""
        from ..checkpoint import Checkpointer
        from ..models import build_model

        meta_path = os.path.join(directory, _META_FILE)
        if not os.path.exists(meta_path):
            raise PipelineError(
                f"{directory!r} is not a QuantizedModel directory "
                f"(missing {_META_FILE}); save one with QuantizedModel.save()")
        device = resolve_device(device)
        with open(meta_path) as f:
            meta = json.load(f)
        cfg = _config_from_sidecar(meta["config"])
        tree, _ = Checkpointer(directory, keep=1).restore_skeleton(
            0, device=device)
        recipe = Recipe(meta["recipe"]["name"],
                        tuple(RecipeStep(s["stage"], s["options"])
                              for s in meta["recipe"]["steps"]),
                        meta["recipe"].get("description", ""))
        return cls(model=build_model(cfg), cfg=cfg,
                   params=_decode_qtensors(tree), recipe=recipe,
                   report=meta.get("report", []),
                   sharding=meta.get("sharding", {}))
