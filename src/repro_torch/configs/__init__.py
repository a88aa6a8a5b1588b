"""Architecture configs the port serves."""
from .registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "get_config", "list_archs"]
