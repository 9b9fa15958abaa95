"""`gluon.contrib` of the port."""
from . import cnn

__all__ = ["cnn"]
