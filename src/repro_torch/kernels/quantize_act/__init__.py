"""Per-row dynamic int8 activation quantization."""
from .ops import quantize_act
from .ref import quantize_act_ref

__all__ = ["quantize_act", "quantize_act_ref"]
