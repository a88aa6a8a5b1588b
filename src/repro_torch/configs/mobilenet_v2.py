"""MobileNetV2-family CNN [arXiv:1801.04381] — the paper's own experimental
architecture (Nagel et al. evaluate DFQ on MobileNetV1/V2 + ResNet18).
Port of ``repro.configs.mobilenet_v2``.

Not part of the LM registry (neither package lists it there): built in
``repro_torch.models.cnn`` with BatchNorm + ReLU6 so the full paper
pipeline (BN fold → ReLU6→ReLU → CLE → BA → analytic BC) applies exactly.
"""
from ..models.cnn import CNNConfig

CONFIG = CNNConfig(
    name="mobilenet_v2",
    in_channels=3,
    num_classes=8,
    width=16,
    blocks=((1, 16, 1), (4, 24, 2), (4, 24, 1), (4, 32, 2), (4, 32, 1)),
    img_size=32,
    act_clip=6.0,
)
