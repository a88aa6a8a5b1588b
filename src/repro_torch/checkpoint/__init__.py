"""Checkpointing of plain tensor trees in the JAX package's on-disk layout
(port of ``repro.checkpoint``)."""
from .checkpointer import CheckpointError, Checkpointer

__all__ = ["CheckpointError", "Checkpointer"]
