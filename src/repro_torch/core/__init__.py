"""The paper's data-free quantization core, in PyTorch (port of
``repro.core``): quantizers, the plan descriptors, norm folding, cross-layer
equalization, bias absorption, and bias correction with the clipped-normal
statistics behind its analytic route."""
from .bias_absorption import absorb_dense, absorb_v_bias, absorption_amount
from .bias_correction import (
    EmpiricalBC,
    bias_correction_conv,
    bias_correction_dense,
    empirical_bias_correction_sequential,
    expected_input_analytic,
    output_bias_error,
    weight_quant_error,
)
from .clipped_normal import (
    clipped_normal_mean,
    clipped_normal_var,
    gaussian_expect,
    relu_normal_mean,
)
from .cle import (
    equalization_scales,
    equalize_dense_pair,
    equalize_qk,
    equalize_vo,
    fold_norm,
)
from .dfq import (
    DFQConfig,
    apply_dfq,
    bias_correct,
    dfq_quantize,
    quantize_weights,
    run_plan_ops,
    weight_quant_snr,
)
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
    fake_quant_with_qparams,
    qparams_from_range,
    quantize,
    sqnr_db,
)
from .tree import get_path, has_path, set_path

__all__ = [
    "DFQConfig", "DFQPlan", "DensePairOp", "EmpiricalBC", "HighBiasAbsorbOp",
    "NormFoldOp", "QKPairOp", "QParams", "QuantSpec", "VBiasAbsorbOp",
    "VOPairOp", "WeightSite", "absorb_dense", "absorb_v_bias",
    "absorption_amount", "apply_dfq", "bias_correct", "bias_correction_conv",
    "bias_correction_dense", "clipped_normal_mean", "clipped_normal_var",
    "compute_qparams", "dequantize", "dfq_quantize",
    "empirical_bias_correction_sequential", "equalization_scales",
    "equalize_dense_pair", "equalize_qk", "equalize_vo",
    "expected_input_analytic", "fake_quant", "fake_quant_with_qparams",
    "fold_norm", "gaussian_expect", "get_path", "has_path",
    "output_bias_error", "qparams_from_range", "quantize", "quantize_weights",
    "relu_normal_mean", "run_plan_ops", "set_path", "sqnr_db",
    "weight_quant_error", "weight_quant_snr",
]
