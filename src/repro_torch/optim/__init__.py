"""The optimizer the CNN flow trains with (port of ``repro.optim``'s
AdamW; its schedule and gradient compression belong to the LM training
substrate, not ported yet)."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]
