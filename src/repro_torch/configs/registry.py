"""Architecture registry: ``--arch <id>`` resolution. The dense decoders of
the JAX package's registry (chameleon-34b is family ``vlm``, an early-fusion
decoder on the dense path); its MoE, SSM, hybrid, encoder-decoder and CNN
archs are not ported yet."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (
    chameleon_34b,
    gemma_7b,
    mistral_nemo_12b,
    qwen2_0_5b,
    yi_34b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_0_5b, yi_34b, mistral_nemo_12b, gemma_7b, chameleon_34b)}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name.endswith("-smoke"):
        name, smoke = name[: -len("-smoke")], True
    try:
        cfg = ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{', '.join(list_archs())}") from None
    return cfg.smoke() if smoke else cfg
