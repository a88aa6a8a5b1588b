"""Elastic scaling's data-shard assignment — port of
``repro.runtime.elastic``'s ``shard_assignment``.

The reference's ``elastic_restore`` re-shards a checkpoint onto a new mesh
(``params_pspecs`` and ``named_shardings`` of its ``sharding`` package,
then ``Checkpointer.restore(shardings=...)``); it waits for the port's
``sharding/`` (the tensor-parallel work item of ROADMAP.md's Queue A). On
one card a restore is ``Checkpointer.restore(target_tree)``.
"""
from __future__ import annotations


def shard_assignment(global_batch: int, world: int, host: int) -> tuple:
    """(shard index, per-host batch) under the current world size. The data
    streams key on the GLOBAL shard index, so a host joining or leaving
    changes only the assignment, never the content of a shard."""
    if world <= 0 or global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{world} hosts")
    return host, global_batch // world
