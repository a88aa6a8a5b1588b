"""The port's kernels: a CUDA kernel and its plain PyTorch version per op,
resolved through one registry (``dispatch``: an explicit tier, then
``REPRO_KERNEL_BACKEND``, then the input's device). Each op's ``ops.py``
registers its tiers with ``@register_impl`` and its smoke-shape spec with
``@register_spec``; ``serving_kernel_specs`` enumerates the specs."""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import (  # noqa: F401  (register)
    fused_decode,
    kv_attention,
    qmatmul_w8a8,
    qmatmul_w8a16,
    quantize_act,
)
from .dispatch import (
    backends,
    iter_specs,
    launch_counts,
    register_spec,
    reset_launch_counts,
)

__all__ = ["backends", "iter_specs", "launch_counts", "lower_serving_kernels",
           "register_spec", "reset_launch_counts", "serving_kernel_specs"]


def serving_kernel_specs(*, head_dim: int = 16, n_kv_heads: int = 2,
                         n_q_heads: int = 4, seq: int = 32, batch: int = 2,
                         d_in: int = 64, d_out: int = 128,
                         device: Optional[Union[str, torch.device]] = "cuda"
                         ) -> dict:
    """{op: (fn, args, kwargs)} for each registered serving op at the JAX
    package's smoke shapes (the smoke config's attention geometry), with
    the tensors on ``device`` (the card unless the caller asks for the
    CPU): ``fn(*args, **kwargs)`` runs the op."""
    from ..device import resolve_device

    return iter_specs(head_dim=head_dim, n_kv_heads=n_kv_heads,
                      n_q_heads=n_q_heads, seq=seq, batch=batch, d_in=d_in,
                      d_out=d_out, device=resolve_device(device))


def lower_serving_kernels(**shape_kw) -> dict:
    """{op: OpGraph} of every registered serving op, each recorded once at
    its spec's shapes (``serving_kernel_specs(**shape_kw)``; ``device``
    "meta" records shapes alone at the plain tier, nothing runs). The
    counterpart of the reference's lowered kernels: the port has no
    compile step, so recording an op means running it."""
    from ..analysis.lint.graph_model import record_graph
    from .dispatch import tier_scope

    meta = str(shape_kw.get("device", "cuda")) == "meta"
    out = {}
    with tier_scope("torch" if meta else None):
        for name, (fn, args, kw) in serving_kernel_specs(**shape_kw).items():
            out[name] = record_graph(name, fn, args, kw)
    return out
