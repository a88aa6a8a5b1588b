"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package is the reference; this package mirrors its module layout
(``kernels/``, ``quantized/``, ``models/``, ``configs/``, ``serving/``,
``launch/``) and serves the W8A8 + int8-KV path through hand-written CUDA
kernels on the card, or through their plain PyTorch versions on the CPU when
the caller passes ``device="cpu"``. It imports no JAX.
"""
from .configs import get_config, list_archs
from .launch.serve_config import ServeConfig, ServeConfigError
from .models import LMModel, ModelConfig, build_model
from .serving import Request, ServingEngine, synthetic_trace

__all__ = ["LMModel", "ModelConfig", "Request", "ServeConfig",
           "ServeConfigError", "ServingEngine", "build_model",
           "get_config", "list_archs", "serve", "synthetic_trace"]


def serve(config: ServeConfig):
    """Build, pack and serve per ``config`` (``launch.serve.serve``)."""
    from .launch.serve import serve as _serve

    return _serve(config)
