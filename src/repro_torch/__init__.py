"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package is the reference; this package mirrors its module layout
(``core/``, ``pipeline/``, ``kernels/``, ``quantized/``, ``models/``,
``configs/``, ``serving/``, ``launch/``, ``checkpoint/``, ``data/``): the
paper's data-free quantization (norm folding, CLE, bias absorption, bias
correction) through the recipe pipeline (``quantize``; ``dfq-int8`` by
default), ``QuantizedModel`` artifacts in the JAX package's layout, and
int8 serving — W8A16 or W8A8 weights with an int8 KV cache — through
hand-written CUDA kernels on the card, or through their plain PyTorch
versions on the CPU when the caller passes ``device="cpu"``. It imports no
JAX.
"""
from .configs import get_config, list_archs
from .launch.serve_config import ServeConfig, ServeConfigError
from .models import LMModel, ModelConfig, build_model
from .pipeline import QuantizedModel, quantize
from .serving import Request, ServingEngine, synthetic_trace

__all__ = ["LMModel", "ModelConfig", "QuantizedModel", "Request",
           "ServeConfig", "ServeConfigError", "ServingEngine", "build_model",
           "get_config", "list_archs", "quantize", "serve",
           "synthetic_trace"]


def serve(config: ServeConfig):
    """Quantize and serve per ``config`` (``launch.serve.serve``)."""
    from .launch.serve import serve as _serve

    return _serve(config)
