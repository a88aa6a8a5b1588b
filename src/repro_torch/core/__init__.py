"""The paper's data-free quantization core, in PyTorch (port of
``repro.core``): quantizers, the plan descriptors, norm folding, cross-layer
equalization and bias absorption. Bias correction and the clipped-normal
statistics are the next slice of the port."""
from .bias_absorption import absorb_dense, absorb_v_bias, absorption_amount
from .cle import (
    equalization_scales,
    equalize_dense_pair,
    equalize_qk,
    equalize_vo,
    fold_norm,
)
from .dfq import DFQConfig, apply_dfq, run_plan_ops
from .graph import (
    DFQPlan,
    DensePairOp,
    HighBiasAbsorbOp,
    NormFoldOp,
    QKPairOp,
    VBiasAbsorbOp,
    VOPairOp,
    WeightSite,
)
from .quantizer import (
    QParams,
    QuantSpec,
    compute_qparams,
    dequantize,
    fake_quant,
    quantize,
    sqnr_db,
)
from .tree import get_path, has_path, set_path

__all__ = [
    "DFQConfig", "DFQPlan", "DensePairOp", "HighBiasAbsorbOp", "NormFoldOp",
    "QKPairOp", "QParams", "QuantSpec", "VBiasAbsorbOp", "VOPairOp",
    "WeightSite", "absorb_dense", "absorb_v_bias", "absorption_amount",
    "apply_dfq", "compute_qparams", "dequantize", "equalization_scales",
    "equalize_dense_pair", "equalize_qk", "equalize_vo", "fake_quant",
    "fold_norm", "get_path", "has_path", "quantize", "run_plan_ops",
    "set_path", "sqnr_db",
]
