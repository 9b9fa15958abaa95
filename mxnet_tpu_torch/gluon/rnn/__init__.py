"""Gluon's recurrent API (the port of `mxnet_tpu.gluon.rnn`): the unfused
cells of `rnn_cell` and the fused layers of `rnn_layer`."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403

from . import rnn_cell, rnn_layer

__all__ = rnn_cell.__all__ + rnn_layer.__all__
