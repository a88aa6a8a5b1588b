"""Architecture registry: ``--arch <id>`` resolution, the JAX package's ten
archs: the dense decoders (chameleon-34b is family ``vlm``, an early-fusion
decoder on the dense path), the MoE ones (mixtral-8x22b with sliding-window
attention, llama4-scout-17b-a16e with a shared expert), the Mamba2 SSM
(mamba2-2.7b), the hybrid (zamba2-2.7b: Mamba2 layers and two shared
attention blocks) and the encoder-decoder (whisper-tiny, its audio front end
a stub: the caller gives the frames). The CNN (``configs.mobilenet_v2``)
has a config of its own."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (
    chameleon_34b,
    gemma_7b,
    llama4_scout_17b_a16e,
    mamba2_2_7b,
    mistral_nemo_12b,
    mixtral_8x22b,
    qwen2_0_5b,
    whisper_tiny,
    yi_34b,
    zamba2_2_7b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_0_5b, yi_34b, mistral_nemo_12b, gemma_7b,
              llama4_scout_17b_a16e, mixtral_8x22b, chameleon_34b,
              whisper_tiny, zamba2_2_7b, mamba2_2_7b)}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name.endswith("-smoke"):
        name, smoke = name[: -len("-smoke")], True
    try:
        cfg = ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the registry holds "
                       f"{', '.join(list_archs())}") from None
    return cfg.smoke() if smoke else cfg
