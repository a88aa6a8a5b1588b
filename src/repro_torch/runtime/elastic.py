"""Elastic scaling: resume the same logical job on a different mesh — port
of ``repro.runtime.elastic``.

Checkpoints are mesh-independent (whole host arrays: a mesh's
``Checkpointer.save(shardings=)`` gathers before rank 0 writes); the two
things a world-size change recomputes are (a) each leaf's placement on the
new mesh and (b) the data-shard assignment. Both are pure functions here,
so an elastic restart is: mesh' = ``make_production_mesh(...)`` →
``elastic_restore(...)`` → continue at the restored step.
"""
from __future__ import annotations

from typing import Any, Optional

from ..sharding.partition import named_shardings, params_pspecs


def elastic_restore(ckpt, target_tree: Any, new_mesh,
                    step: Optional[int] = None,
                    heads: Optional[dict] = None):
    """Restore a checkpoint onto a NEW mesh (another shape or size than the
    one it was written from): the planner's specs of ``target_tree`` (the
    whole state's shapes; meta tensors will do) on ``new_mesh``, then
    ``ckpt.restore(shardings=)`` — each rank gets its blocks, bit for bit.
    ``heads`` ({"n_q", "n_kv"}) adds the head rule of the attention
    projections, the train step's placement (the reference passes none:
    under GSPMD a jitted step re-places its inputs, here the blocks must be
    the step's own). ``new_mesh=None`` restores whole, onto one device.
    Returns ``(tree, step)``."""
    if new_mesh is None:
        return ckpt.restore(target_tree, step=step)
    specs = params_pspecs(target_tree, new_mesh, heads)
    return ckpt.restore(target_tree, step=step,
                        shardings=named_shardings(specs, new_mesh))


def shard_assignment(global_batch: int, world: int, host: int) -> tuple:
    """(shard index, per-host batch) under the current world size. The data
    streams key on the GLOBAL shard index, so a host joining or leaving
    changes only the assignment, never the content of a shard."""
    if world <= 0 or global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{world} hosts")
    return host, global_batch // world
