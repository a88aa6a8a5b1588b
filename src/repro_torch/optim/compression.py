"""Int8 error-feedback gradient compression for the cross-replica mean —
port of ``repro.optim.compression``.

Error feedback keeps a per-tensor residual of the int8 quantization error
and adds it back before the next round, so the compressed mean is
unbiased over time (the paper's point that quantization error is biased
and must be corrected, §4.2, applied to gradients). ``compressed_mean``
all-gathers the int8 payload and one float32 scale a rank over a
``torch.distributed`` group (a mesh axis's) — the payload a byte an
element — and takes the dequantized mean locally, in the reference's
order.
"""
from __future__ import annotations

from typing import Optional

import torch


def ef_init(grads):
    """Zero float32 residuals shaped like ``grads`` (a tree of tensors)."""
    from .adamw import _map

    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def ef_compress(g: torch.Tensor, residual: torch.Tensor):
    """Quantize g + residual to int8: (q, scale, new residual). Bit-equal to
    the JAX function: scale = max(max |x|, 1e-12) / 127 as a tensor, x
    divided by it (never times its reciprocal), rounded half to even,
    clipped to ±127."""
    x = g.float() + residual
    scale = torch.clamp_min(x.abs().max(), 1e-12) / x.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - q.float() * scale


def gathered_mean(q_all: torch.Tensor, s_all: torch.Tensor) -> torch.Tensor:
    """The mean of n dequantized payloads, q_all [n, ...] int8 and s_all
    [n] float32: (s_all / n) contracted with q_all over the rank axis, as
    the reference's ``tensordot``."""
    n = q_all.shape[0]
    return torch.tensordot(s_all / n, q_all.float(), dims=([0], [0]))


def compressed_mean(g: torch.Tensor, residual: torch.Tensor,
                    group: Optional[object] = None, *, mesh=None):
    """The mean of ``g`` over the ranks of ``group`` with an int8 payload
    and error feedback: (mean float32, new residual). ``group`` is a
    process group (default: the world), or a mesh axis's name with
    ``mesh`` (a ``DeviceMesh``), as the reference names its axis. Every
    rank must call it with the same shape. The payloads and scales are
    gathered by ``sharding.collectives.all_gather`` (bytes summed through
    ``all_reduce``), so gloo and NCCL run the same code, on the CPU and
    the card."""
    import torch.distributed as dist

    from ..sharding import collectives as coll

    if isinstance(group, str):
        if mesh is None:
            raise ValueError(f"compressed_mean over axis {group!r} needs "
                             "the mesh")
        group = mesh.get_group(group)
    elif group is None:
        group = dist.group.WORLD
    q, scale, new_residual = ef_compress(g, residual)
    q_all = coll.all_gather(q[None], 0, group)
    s_all = coll.all_gather(scale.reshape(1), 0, group)
    return gathered_mean(q_all, s_all), new_residual
