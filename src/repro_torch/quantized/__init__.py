"""int8 weights: the QTensor container and the serving pack stage."""
from .ptq import (
    dequantize_params,
    quantize_for_serving,
    quantize_shapes,
    serving_summary,
)
from .qtensor import (
    QTensor,
    map_leaves,
    qtensor_matmul,
    qtensor_matmul_prequant,
    quantize_input,
    quantize_param,
)

__all__ = ["QTensor", "dequantize_params", "map_leaves", "qtensor_matmul",
           "qtensor_matmul_prequant", "quantize_for_serving",
           "quantize_input", "quantize_param", "quantize_shapes",
           "serving_summary"]
