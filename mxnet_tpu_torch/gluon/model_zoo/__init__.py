"""Model zoo of the port (vision: the ResNets; bert: GluonNLP's BERT)."""
from . import bert, vision
from .vision import get_model

__all__ = ["bert", "vision", "get_model"]
