"""Gluon layers of the port."""
from . import activations, basic_layers, conv_layers
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403

__all__ = (activations.__all__ + basic_layers.__all__ +
           conv_layers.__all__)
