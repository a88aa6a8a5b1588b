"""Dry-run of every (arch × shape × mesh) cell without the model in memory —
port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's jitted program against
``ShapeDtypeStruct`` inputs on 256 or 512 forced host devices and reads
XLA's cost and memory analyses. The port runs the real step eagerly on the
``meta`` device (shapes and dtypes, no storage), as rank 0 of a fake
``torch.distributed`` world of the mesh's size (``fake_mesh``: the "fake"
backend of ``torch.testing._internal.distributed.fake_pg``, whose
collectives do nothing), under the plain kernel tier (``tier_scope
("torch")``: the CUDA kernels take no meta tensor). It records:

  * FLOPs — ``torch.utils.flop_counter.FlopCounterMode`` over the step,
    the backward and remat's recompute included (matmul-class operations:
    the GEMMs, attention's einsums, convolutions, ``_int_mm``);
  * bytes — each operation's inputs read and outputs written, views
    moving none: the unfused count, the pessimistic bound as the
    reference's HLO ``bytes accessed`` is;
  * collective bytes — each logical collective's result bytes on this
    rank (``sharding.collectives.record_collectives``), by kind: what the
    port runs, so FSDP's gradient sum counts as an all-reduce of the whole
    gradient, n times the block that the reference's reduce-scatter
    leaves; the roofline's collective term reads this total;
  * memory — ``argument_size_in_bytes``, the planner's blocks of the
    step's arguments on this rank (``sharding.partition.block_bytes``);
    ``alias_size_in_bytes``, what the step donates (the params and AdamW
    moments of a train step, updated in place; the cache of a decode
    step, written in place); ``temp_size_in_bytes``, the peak of the live
    bytes of the storages the step allocates (each counted from the
    operation that makes it until it is freed); ``output_size_in_bytes``,
    the storages of its results; ``hbm_used_per_device`` = arguments +
    temp, against ``HW_H100["hbm_per_chip"]``;
  * the roofline terms (``analysis.roofline``, the H100's constants).

Eager tracing counts every layer, so each cell is counted at full depth;
``cost.per_layer`` is the slope between that count and a second one at
the reference's first probe depth (1 layer; a hybrid's attention period).
The reference's ``generated_code_size_in_bytes`` and ``hlo_len`` have no
counterpart (no compiled program, no HLO) and are left out; its
``collectives_main_hlo`` is ``collectives`` here and its
``hlo_flops_global`` ``flops_global``.

Placement, as the port runs each kind over a mesh:

  * train — ``launch.steps.make_train_step`` under
    ``configure_sharding_hints``: params and AdamW moments as this rank's
    blocks of the train-mode specs (FSDP over "data", TP over "model"),
    the global batch, of which the step takes this rank's rows;
  * prefill and decode — the serving forward under ``sharding.tp
    .ServeShard`` (the serve-mode specs: weights resident, TP over
    "model"; this rank's batch rows and KV heads of the per-slot cache),
    quantized (``--quantized``: ``quantized.quantize_shapes``, W8A16)
    or not. The SSM, hybrid and encoder-decoder families, whose serving
    the port (as the reference's engine) refuses over a mesh, run
    data-parallel: this rank's batch rows, every weight whole.

Results go to ``results/dryrun_torch/<cell>.json``; reruns skip cells
already ok or skipped (``--force`` redoes them).

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k \
      --mesh single --quantized --kv8
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..analysis.roofline import HW_H100, roofline_report
from ..configs import get_config, list_archs
from ..models import (
    SHAPE_BY_NAME,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    build_model,
    input_specs,
    shape_applicable,
)
from ..optim.adamw import AdamWState, adamw_init
from ..quantized.qtensor import QTensor
from ..sharding.collectives import record_collectives
from ..sharding.partition import (
    P,
    batch_pspec,
    block_bytes,
    block_shape,
    opt_spec_tree,
    params_pspecs,
    replicated_pspecs,
    serve_cache_pspecs,
    shard_tree,
)
from .serve import UNSERVABLE_FAMILIES

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


@contextlib.contextmanager
def fake_mesh(shape: tuple):
    """A ``DeviceMesh`` of ``shape`` (("data", "model"), or ("pod", "data",
    "model") for three dims) over a fake world of that many ranks, this
    process its rank 0; the world is destroyed on leaving. Refuses to run
    where a process group already exists."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run builds its own fake world: a process "
                           "group already exists in this process")
    n = math.prod(shape)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                          mesh_dim_names=axes)
        if len(shape) == 3:
            # rank 0's (pod, data) group, as launch.mesh builds it
            grid = torch.arange(n).reshape(shape[0] * shape[1], shape[2])
            mesh.repro_dp_group = dist.new_group(grid[:, 0].tolist())
        yield mesh
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors(tree, device: Optional[str] = "meta") -> list:
    """The tensors of a tree on ``device`` (a device type; None: on any),
    a ``QTensor``'s payload and scale too."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v, device)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v, device)]
    if isinstance(tree, QTensor):
        return tensors((tree.q, tree.scale), device)
    return ([tree] if isinstance(tree, torch.Tensor)
            and device in (None, tree.device.type) else [])


class _Tally(TorchDispatchMode):
    """Bytes each operation reads and writes (views and the fake
    collectives move none), and the live and peak bytes of the storages
    the traced step allocates. ``known`` storages (the arguments) are
    never counted as allocated."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._alive: dict = {}
        self._known = {id(t.untyped_storage()) for t in tensors(known)}

    def _free(self, key):
        self.live -= self._alive.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = tensors(out)
        if func.is_view or func.namespace == "c10d":
            return out
        self.bytes += sum(map(_nbytes, tensors((args, kwargs)) + outs))
        if func._schema.is_mutable:
            return out                      # writes storages it was given
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._alive or key in self._known:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def _flop_counter():
    """A ``FlopCounterMode``, with ``_int_mm`` counted as 2·M·K·N where the
    installed torch has no formula for it."""
    from torch.utils import flop_counter as fc

    if torch.ops.aten._int_mm not in fc.flop_registry:
        @fc.register_flop_formula(torch.ops.aten._int_mm)
        def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
            return 2 * a_shape[0] * a_shape[1] * b_shape[1]

    return fc.FlopCounterMode(display=False)


@dataclasses.dataclass
class Traced:
    """One eager meta trace of a cell's step on rank 0."""
    flops: float
    bytes: float
    collectives: dict
    argument_bytes: int
    alias_bytes: int
    output_bytes: int
    temp_bytes: int
    seconds: float


def _rows(mesh, B: int) -> tuple:
    """(this rank's batch rows, their spec): the global batch cut over
    the data-parallel axes where it divides them (``batch_pspec``)."""
    spec = batch_pspec(mesh, batch=B)
    return block_shape((B,), spec[:1], mesh)[0], spec


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               chunk_kv: Optional[int] = 2048, donate: bool = True,
               quantized: Optional[str] = None) -> Traced:
    """Run one step of the cell on meta tensors as rank 0 of ``mesh`` and
    count it. ``quantized`` ("w8a16" | "w8a8", decode and prefill only)
    swaps every weight site for a meta ``QTensor`` of that mode."""
    from ..kernels.dispatch import tier_scope
    from ..quantized import quantize_shapes
    from ..sharding.tp import ServeShard, tp_scope
    from .steps import (
        armed_shard,
        clear_sharding_hints,
        configure_sharding_hints,
        make_train_step,
    )

    model = build_model(cfg)
    params_shape = model.init(0, device="meta")
    heads = {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads}
    specs = input_specs(cfg, shape)
    B = shape.global_batch
    # a mesh of one rank is one device: the single-device code, no shard
    one = math.prod(mesh.shape) == 1
    t0 = time.perf_counter()
    if shape.kind == "train":
        p_spec = params_pspecs(params_shape, mesh, heads, mode="train")
        o_spec = opt_spec_tree(p_spec)
        opt_shape = adamw_init(params_shape)
        # the step on the host: the schedule reads it there
        opt = AdamWState(torch.zeros((), dtype=torch.int32),
                         shard_tree(opt_shape.m, o_spec.m, mesh),
                         shard_tree(opt_shape.v, o_spec.v, mesh))
        params = shard_tree(params_shape, p_spec, mesh)
        batch = {k: specs[k] for k in ("tokens", "labels")}
        b_spec = {k: batch_pspec(mesh, batch=B) for k in batch}
        if cfg.is_encdec:
            batch["frames"] = specs["frames"]
            b_spec["frames"] = batch_pspec(mesh, ndim=3, batch=B)
        args = (params, opt, batch)
        state = block_bytes((params_shape, opt_shape.m, opt_shape.v),
                            (p_spec, o_spec.m, o_spec.v), mesh)
        argument = (state + _nbytes(opt.step)
                    + block_bytes(batch, b_spec, mesh))
        alias = state if donate else 0
        step_model, step = make_train_step(cfg, chunk_kv=chunk_kv,
                                           donate=donate)

        @contextlib.contextmanager
        def hints():
            if not one:
                configure_sharding_hints(cfg, mesh)
            try:
                yield
            finally:
                clear_sharding_hints()

        # the shard's specs come from whole params drawn on meta, which on
        # the card take no memory either: built before the count
        with hints():
            armed_shard(step_model)

        def run():
            with hints():
                return step(*args)
    else:
        if quantized:
            params_shape = quantize_shapes(params_shape, model.dfq_plan(),
                                           mode=quantized)
        rows, b_spec = _rows(mesh, B)
        shard = None
        if one or cfg.family in UNSERVABLE_FAMILIES:
            p_spec = replicated_pspecs(params_shape)
        else:
            shard = ServeShard(mesh, cfg, params_shape, num_slots=B,
                               paged=False, backend="fake")
            p_spec = shard.specs
        params = shard_tree(params_shape, p_spec, mesh)
        if (shape.kind == "decode"
                and cfg.family not in UNSERVABLE_FAMILIES):
            # the serving pool: this rank's slots and KV heads
            whole = model.init_cache(B, shape.seq_len, device="meta",
                                     per_slot=True, dtype=torch.bfloat16)
            c_spec = serve_cache_pspecs(whole, mesh)
        else:
            # the whole-batch cache (the prefill step's, and every step's
            # of the families served data-parallel): this rank's rows
            # (axis 1), and its KV heads (axis 3) where the shard cuts them
            whole = model.init_cache(B, shape.seq_len, device="meta",
                                     per_slot=False, dtype=torch.bfloat16)
            heads_ax = ("model" if shard is not None
                        and shard.kv_heads_sharded else None)
            c_spec = {k: (P() if v.ndim < 2 else
                          P(None, b_spec[0], None, heads_ax) if v.ndim >= 4
                          else P(None, b_spec[0]))
                      for k, v in whole.items()}
        cache = shard_tree(whole, c_spec, mesh)
        key = "token" if shape.kind == "decode" else "tokens"
        tokens = torch.empty((rows,) + tuple(specs[key].shape[1:]),
                             dtype=specs[key].dtype, device="meta")
        frames = None
        if cfg.is_encdec and shape.kind == "prefill":
            frames = torch.empty((rows,) + tuple(specs["frames"].shape[1:]),
                                 dtype=specs["frames"].dtype, device="meta")
        args = (params, cache, tokens, frames)
        argument = (block_bytes(params_shape, p_spec, mesh)
                    + block_bytes(whole, c_spec, mesh)
                    + sum(map(_nbytes, tensors((tokens, frames)))))
        alias = (block_bytes(whole, c_spec, mesh)
                 if donate and shape.kind == "decode" else 0)

        def run():
            with tp_scope(shard):
                c = cache
                if frames is not None:
                    c = model.warm_cache(params, frames, c)
                if shape.kind == "decode":
                    return model.decode_step(params, tokens, c)
                return model.prefill(params, tokens, c, chunk_kv=chunk_kv)

    tally = _Tally(known=args)
    fc = _flop_counter()
    with tier_scope("torch"), record_collectives() as rec, fc, tally:
        out = run()
    given = {id(t.untyped_storage()) for t in tensors(args)}
    output = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in tensors(out)
                  if id(t.untyped_storage()) not in given}.values())
    return Traced(flops=float(fc.get_total_flops()), bytes=float(tally.bytes),
                  collectives={**rec.bytes, "total": rec.total,
                               "counts": dict(rec.counts)},
                  argument_bytes=int(argument), alias_bytes=int(alias),
                  output_bytes=int(output), temp_bytes=int(tally.peak),
                  seconds=time.perf_counter() - t0)


def _probe_layers(cfg) -> int:
    return cfg.hybrid_attn_every if cfg.family == "hybrid" else 1


def _probe_cfg(cfg, L):
    kw = dict(n_layers=L)
    if cfg.is_encdec:
        kw["n_enc_layers"] = L
    return dataclasses.replace(cfg, **kw)


def dry_run(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: tuple, *,
            chunk_kv: Optional[int] = 2048, donate: bool = True,
            quantized: Optional[str] = None, probe: bool = True) -> dict:
    """The result of one cell (``run_cell``'s, without the registry
    lookups): ``cfg`` at ``shape`` over a fake mesh of ``mesh_shape``."""
    chips = math.prod(mesh_shape)
    model_n = mesh_shape[-1]
    with fake_mesh(mesh_shape) as mesh:
        full = trace_step(cfg, shape, mesh, chunk_kv=chunk_kv, donate=donate,
                          quantized=quantized)
        per_layer = None
        L1 = _probe_layers(cfg)
        if probe and cfg.n_layers > L1:
            low = trace_step(_probe_cfg(cfg, L1), shape, mesh,
                             chunk_kv=chunk_kv, donate=donate,
                             quantized=quantized)
            span = cfg.n_layers - L1
            per_layer = {
                "flops": (full.flops - low.flops) / span,
                "bytes": (full.bytes - low.bytes) / span,
                "collective_bytes": (full.collectives["total"]
                                     - low.collectives["total"]) / span}
    terms = roofline_report(
        per_device_flops=full.flops, per_device_bytes=full.bytes,
        per_device_collective_bytes=full.collectives["total"], chips=chips,
        cfg=cfg, shape=shape, quantized=bool(quantized), model_n=model_n)
    memory = {"argument_size_in_bytes": full.argument_bytes,
              "output_size_in_bytes": full.output_bytes,
              "temp_size_in_bytes": full.temp_bytes,
              "alias_size_in_bytes": full.alias_bytes}
    hbm_used = full.argument_bytes + full.temp_bytes
    return {
        "status": "ok",
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(map(str, mesh_shape)),
        "chips": chips,
        "placement": ("one device" if chips == 1
                      else "train" if shape.kind == "train"
                      else "data-parallel"
                      if cfg.family in UNSERVABLE_FAMILIES else "serve"),
        "memory": memory,
        "hbm_used_per_device": hbm_used,
        "fits_hbm": bool(hbm_used < HW_H100["hbm_per_chip"]),
        "cost": {"flops": full.flops, "bytes": full.bytes,
                 "collective_bytes": float(full.collectives["total"]),
                 "per_layer": per_layer},
        "collectives": full.collectives,
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "memory_analytic_s": terms.memory_analytic_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "bound_time_s": terms.bound_time_s,
            "model_flops": terms.model_flops,
            "flops_global": terms.flops_global,
            "useful_flops_ratio": terms.useful_flops_ratio,
            "roofline_fraction": terms.roofline_fraction,
        },
        "timings": {"trace_s": full.seconds},
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             chunk_kv: Optional[int] = 2048, donate: bool = True,
             quantized: bool = False, kv8: bool = False) -> dict:
    """One cell of the registry at the production mesh: 16x16, or
    2x16x16 with ``multi_pod``; ``quantized`` the W8A16 decode variant,
    ``kv8`` the int8 KV cache."""
    cfg = get_config(arch)
    if kv8:
        cfg = dataclasses.replace(cfg, kv_cache_bits=8)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    if quantized and shape.kind != "decode":
        return {"status": "skipped", "reason": "W8A16 variant is decode-only"}
    t0 = time.perf_counter()
    result = dry_run(cfg, shape, (2, 16, 16) if multi_pod else (16, 16),
                     chunk_kv=chunk_kv, donate=donate,
                     quantized="w8a16" if quantized else None)
    result["timings"]["total_s"] = time.perf_counter() - t0
    return result


def cell_path(arch, shape_name, multi_pod, tag=""):
    mesh = "multi" if multi_pod else "single"
    return os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh}{tag}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for perf-iteration variants")
    ap.add_argument("--chunk-kv", type=int, default=2048)
    ap.add_argument("--quantized", action="store_true",
                    help="W8A16 QTensor weights (decode cells)")
    ap.add_argument("--kv8", action="store_true", help="int8 KV cache")
    args = ap.parse_args(argv)
    if args.quantized and not args.tag:
        args.tag = "_w8a16" + ("_kv8" if args.kv8 else "")

    os.makedirs(RESULTS_DIR, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = ([s.name for s in SHAPES] if (args.all or args.shape is None)
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                path = cell_path(arch, shape_name, multi, args.tag)
                where = f"{arch} × {shape_name} × {'multi' if multi else 'single'}"
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached] {where}: {prev['status']}")
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skipped"
                        continue
                print(f"[run] {where} ...", flush=True)
                try:
                    result = run_cell(arch, shape_name, multi,
                                      chunk_kv=args.chunk_kv,
                                      quantized=args.quantized, kv8=args.kv8)
                except Exception as e:  # noqa: BLE001 - a cell's failure is recorded
                    result = {"status": "error", "error": repr(e),
                              "traceback": traceback.format_exc()[-4000:]}
                    n_fail += 1
                    print(f"  ERROR: {e}")
                else:
                    if result["status"] == "ok":
                        n_ok += 1
                        r = result["roofline"]
                        print(f"  ok: dominant={r['dominant']} "
                              f"bound={r['bound_time_s']:.4f}s "
                              f"useful={r['useful_flops_ratio']:.2f} "
                              f"fits_hbm={result['fits_hbm']} "
                              f"trace={result['timings']['total_s']:.0f}s")
                    else:
                        n_skip += 1
                        print(f"  skipped: {result['reason']}")
                with open(path, "w") as f:
                    json.dump(result, f, indent=1)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
