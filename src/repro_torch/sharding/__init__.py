"""Tensor-parallel serving: the partition planner (``partition``, the JAX
package's rules over shapes), the collectives the sharded forward needs
(``collectives``) and one rank's part of a sharded engine (``tp``)."""
from .partition import (  # noqa: F401
    PartitionSpec,
    batch_pspec,
    cache_pspecs,
    params_pspecs,
    payload_scale_pairs,
    serve_cache_pspecs,
    shard_tree,
    spec_paths,
)
