"""Architecture registry: ``--arch <id>`` resolution. The decoders of the
JAX package's registry: the dense ones (chameleon-34b is family ``vlm``, an
early-fusion decoder on the dense path) and the MoE ones (mixtral-8x22b with
sliding-window attention, llama4-scout-17b-a16e with a shared expert); its
SSM, hybrid, encoder-decoder and CNN archs are not ported yet."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (
    chameleon_34b,
    gemma_7b,
    llama4_scout_17b_a16e,
    mistral_nemo_12b,
    mixtral_8x22b,
    qwen2_0_5b,
    yi_34b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_0_5b, yi_34b, mistral_nemo_12b, gemma_7b,
              llama4_scout_17b_a16e, mixtral_8x22b, chameleon_34b)}


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
