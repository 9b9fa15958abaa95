"""Model zoo of the port (vision: the reference's 34 vision models; bert:
GluonNLP's BERT)."""
from . import bert, vision
from .vision import get_model

__all__ = ["bert", "vision", "get_model"]
