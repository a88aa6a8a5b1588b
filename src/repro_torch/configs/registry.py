"""Architecture registry: ``--arch <id>`` resolution. Only the archs the
port serves so far are listed."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import qwen2_0_5b

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (qwen2_0_5b,)}


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
