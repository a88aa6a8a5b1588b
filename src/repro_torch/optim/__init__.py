"""The optimizer substrate (port of ``repro.optim``): AdamW, the cosine
learning-rate schedule, and int8 error-feedback gradient compression."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .compression import compressed_mean, ef_compress, ef_init
from .schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "compressed_mean",
           "cosine_schedule", "ef_compress", "ef_init", "global_norm"]
