"""Serialization of the port (`.params` files)."""
from . import params_serde

__all__ = ["params_serde"]
