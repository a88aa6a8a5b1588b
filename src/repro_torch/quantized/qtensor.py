"""QTensor: the int8 weight container the model code dispatches on.

As in ``repro.quantized.qtensor``, ``models.layers.linear`` routes an
activation through a ``QTensor`` weight by its mode:

    y = x @ W          (torch.Tensor)
    y = w8a8(q(x), W)  (QTensor, mode="w8a8": dynamic act quant + int8 GEMM)
    y = w8a16(x, W)    (QTensor, mode="w8a16": int8 weight, fp activation)

A W8A8 weight takes ``q(x)`` inside the GEMM wherever ``gemm_plan`` folds
(``GemmPlan.fold``: every decode tile, M <= 16) — the quantize-in op
``qmatmul_w8a8_qin``, one launch, the same bits — whose launch also hands
``q(x)`` to the other projections reading x (the qkv trio, the gate/up
pair); elsewhere (a prefill chunk) one ``quantize_act`` launch is shared by
every projection reading x.

An expert-stacked weight (the MoE block's, ``q`` [E, K, N] and ``scale``
[E, N] or [E, 1] once the layer is sliced) takes an activation [E, ..., K]
and routes every expert's rows through ONE launch of the same kernels,
the expert index in the grid — what the reference's ``jax.vmap`` of
``linear`` over the expert axis computes. Rows are quantized one by one,
so the W8A8 route's int8 rows are bitwise the flat ``quantize_act``'s.

Layout: ``q`` is the public [..., K, N] view, as in the JAX package, but its
storage is K-major — a contiguous [..., N, K] buffer, transposed — which is
the B operand layout both GEMM kernels read. The constructor normalizes any
other layout once, so no GEMM call ever copies a weight.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def k_major(q: torch.Tensor) -> torch.Tensor:
    """``q`` [..., K, N] with [..., N, K]-contiguous storage (a no-op when it
    already is)."""
    t = q.transpose(-1, -2)
    return q if t.is_contiguous() else t.contiguous().transpose(-1, -2)


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor                # int8 payload [..., K, N] (K-major storage)
    scale: torch.Tensor            # [..., N] or [..., 1] (symmetric)
    mode: str = "w8a16"            # w8a16 | w8a8

    def __post_init__(self):
        self.q = k_major(self.q)

    def __getitem__(self, i) -> "QTensor":
        """Slice the stacked leading (layer) axis."""
        return QTensor(self.q[i], self.scale[i], self.mode)

    def dequant(self) -> torch.Tensor:
        """The float32 image ``q · scale`` (the pack stage's SQNR input)."""
        return self.q.to(torch.float32) * self.scale.to(torch.float32)[..., None, :]


def map_leaves(fn, tree):
    """Apply ``fn`` to every tensor of a params tree (a QTensor's q and
    scale; the payload's K-major storage is kept)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.q), fn(tree.scale), tree.mode)
    return fn(tree)


def quantize_param(w: torch.Tensor, *, per_channel: bool = True,
                   mode: str = "w8a16") -> QTensor:
    """Symmetric int8 quantization of a [..., K, N] weight (per-out-channel
    or per-tensor scale), in the order of the JAX ``quantize_param``."""
    if per_channel:
        amax = w.abs().amax(dim=-2)                                  # [..., N]
    else:
        amax = w.abs().amax(dim=(-2, -1), keepdim=True)[..., 0]      # [..., 1]
    scale = torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127)
    return QTensor(q.to(torch.int8), scale.to(torch.float32), mode)


def gemm_rows(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] as the GEMM's A: [M, K], or [E, M, K] for an
    expert-stacked ``w`` (x's leading dim the expert's)."""
    if w.q.ndim == 3:
        return x.reshape(w.q.shape[0], -1, x.shape[-1])
    return x.reshape(-1, x.shape[-1])


def quantize_input(x: torch.Tensor):
    """Dynamic-quantize an activation once for every W8A8 projection that
    reads it (the qkv trio, the GLU gate/up pair) where their GEMMs do not
    quantize it themselves: returns (x_q int8 [M, K], x_scale float32 [M],
    lead shape)."""
    from ..kernels.quantize_act.ops import quantize_act

    lead = tuple(x.shape[:-1])
    a_q, a_s = quantize_act(x.reshape(-1, x.shape[-1]))
    return a_q, a_s, lead


def quantizes_in_gemm(x: torch.Tensor, *ws: QTensor) -> bool:
    """Whether the W8A8 GEMMs of ``ws`` on the activation x [..., K] take
    x in float, the first quantizing it: the plan folds for every one."""
    from ..kernels import gemm_plan

    E = ws[0].q.shape[0] if ws[0].q.ndim == 3 else 1
    M, K = x.numel() // x.shape[-1] // E, x.shape[-1]
    return all(gemm_plan.plan(M, w.q.shape[-1], K, experts=E).fold
               for w in ws)


def qtensor_matmul(x: torch.Tensor, w: QTensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Route an activation [..., K] through a quantized weight."""
    from ..kernels.qmatmul_w8a8.ops import qmatmul_w8a8_qin
    from ..kernels.qmatmul_w8a16.ops import qmatmul_w8a16

    if w.q.ndim not in (2, 3):
        raise ValueError("stacked QTensors must be sliced per layer before use")
    if w.mode == "w8a8":
        if quantizes_in_gemm(x, w):
            y = qmatmul_w8a8_qin(gemm_rows(x, w), w.q, w.scale, bias,
                                 out_dtype=x.dtype)
            return y.reshape(*x.shape[:-1], w.q.shape[-1])
        a_q, a_s, lead = quantize_input(x)
        return qtensor_matmul_prequant(a_q, a_s, w, bias, lead,
                                       out_dtype=x.dtype)
    if w.mode != "w8a16":
        raise ValueError(f"QTensor mode {w.mode!r}: w8a16 or w8a8")
    y = qmatmul_w8a16(gemm_rows(x, w), w.q, w.scale, bias,
                      out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], w.q.shape[-1])


def qtensor_matmul_prequant(a_q: torch.Tensor, a_s: torch.Tensor, w: QTensor,
                            bias: Optional[torch.Tensor], lead: tuple, *,
                            out_dtype: torch.dtype = torch.float32):
    """W8A8 matmul over an already-quantized activation (from
    ``quantize_input``, a quantize-in GEMM or the fused decode's
    quantize-out epilogue): a_q [M, K] and a_s [M], their rows the
    experts' in turn for an expert-stacked ``w``."""
    from ..kernels.qmatmul_w8a8.ops import qmatmul_w8a8

    if w.mode != "w8a8":
        raise ValueError("prequantized inputs feed W8A8 weights")
    if w.q.ndim == 3:
        E = w.q.shape[0]
        a_q, a_s = a_q.reshape(E, -1, a_q.shape[-1]), a_s.reshape(E, -1)
    y = qmatmul_w8a8(a_q, w.q, a_s, w.scale, bias, out_dtype=out_dtype)
    return y.reshape(*lead, w.q.shape[-1])
