"""Model zoo of the port (vision: the ResNets)."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
