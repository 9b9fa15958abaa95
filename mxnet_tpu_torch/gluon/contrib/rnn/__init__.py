"""`gluon.contrib.rnn` (the port of `mxnet_tpu.gluon.contrib.rnn`):
`VariationalDropoutCell`, `LSTMPCell`, the convolutional cells and the
shared cell classes of `gluon.rnn`."""
from ...rnn import (BidirectionalCell, DropoutCell, GRUCell, LSTMCell,
                    ModifierCell, ResidualCell, RNNCell, SequentialRNNCell,
                    ZoneoutCell)
from .conv_rnn_cell import (Conv1DGRUCell, Conv1DLSTMCell, Conv1DRNNCell,
                            Conv2DGRUCell, Conv2DLSTMCell, Conv2DRNNCell,
                            Conv3DGRUCell, Conv3DLSTMCell, Conv3DRNNCell)
from .rnn_cell import LSTMPCell, VariationalDropoutCell

__all__ = ["RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "BidirectionalCell", "DropoutCell", "ResidualCell",
           "ZoneoutCell", "ModifierCell", "VariationalDropoutCell",
           "LSTMPCell", "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]
