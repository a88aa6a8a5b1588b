"""The models in PyTorch (port of ``repro.models``): the decoder-only LM
(dense, MoE, the Mamba2 SSM and the zamba2 hybrid), the whisper-style
encoder-decoder, and the paper's MobileNetV2-style CNN
(``repro.models.cnn``)."""
from .cnn import CNNConfig, MobileNetCNN
from .config import SHAPE_BY_NAME, SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .encdec import EncDecModel
from .lm import LMModel
from .model import build_model, cache_specs, input_specs

__all__ = ["CNNConfig", "EncDecModel", "LMModel", "MobileNetCNN", "ModelConfig", "SHAPES",
           "SHAPE_BY_NAME", "ShapeConfig", "build_model", "cache_specs",
           "input_specs", "shape_applicable"]
