"""Sharding over a ``torch.distributed`` mesh: the partition planner
(``partition``, the JAX package's rules over shapes), the collectives the
sharded forwards need (``collectives``: the serving ones, and the training
ones with a gradient), one rank's part of a sharded serving engine (``tp``)
and of a sharded train step (``train``)."""
from .partition import (  # noqa: F401
    NamedSharding,
    PartitionSpec,
    batch_pspec,
    block_bytes,
    cache_pspecs,
    named_shardings,
    opt_spec_tree,
    params_pspecs,
    payload_scale_pairs,
    serve_cache_pspecs,
    shard_tree,
    spec_paths,
    unshard_tree,
)
