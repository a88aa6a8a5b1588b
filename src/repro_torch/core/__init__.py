"""The paper's data-free quantization core, in PyTorch (port of
``repro.core``): quantizers, the plan descriptors, norm and BatchNorm
folding, cross-layer equalization (transformer pairs and conv chains),
high-bias and value-bias absorption, bias correction with the
clipped-normal statistics behind its analytic route, and the adversarial
rescale that makes a model hard to quantize."""
from .adversarial import hostile_rescale
from .bias_absorption import (
    absorb_conv,
    absorb_dense,
    absorb_v_bias,
    absorption_amount,
)
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
from .bn_folding import BNParams, FoldedLayer, fold_bn_conv
from .cle import (
    ConvLayer,
    equalization_scales,
    equalize_conv_chain,
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
    channel_precision,
    channel_ranges,
    compute_qparams,
    dequantize,
    fake_quant,
    fake_quant_with_qparams,
    qparams_from_range,
    quantize,
    sqnr_db,
    tensor_range,
)
from .tree import get_path, has_path, set_path

__all__ = [
    "BNParams", "ConvLayer", "DFQConfig", "DFQPlan", "DensePairOp",
    "EmpiricalBC", "FoldedLayer", "HighBiasAbsorbOp", "NormFoldOp",
    "QKPairOp", "QParams", "QuantSpec", "VBiasAbsorbOp", "VOPairOp",
    "WeightSite", "absorb_conv", "absorb_dense", "absorb_v_bias",
    "absorption_amount", "apply_dfq", "bias_correct", "bias_correction_conv",
    "bias_correction_dense", "channel_precision", "channel_ranges",
    "clipped_normal_mean", "clipped_normal_var", "compute_qparams",
    "dequantize", "dfq_quantize", "empirical_bias_correction_sequential",
    "equalization_scales", "equalize_conv_chain", "equalize_dense_pair",
    "equalize_qk", "equalize_vo", "expected_input_analytic", "fake_quant",
    "fake_quant_with_qparams", "fold_bn_conv", "fold_norm", "gaussian_expect",
    "get_path", "has_path", "hostile_rescale", "output_bias_error",
    "qparams_from_range", "quantize", "quantize_weights", "relu_normal_mean",
    "run_plan_ops", "set_path", "sqnr_db", "tensor_range",
    "weight_quant_error", "weight_quant_snr",
]
