"""`gluon.contrib` of the port: the fused conv blocks (`cnn`),
`IntervalSampler` (`data`), the `Estimator` (`estimator`), the layers of
`nn` and the recurrent cells of `rnn`."""
from . import cnn
from . import data
from . import estimator
from . import nn
from . import rnn

__all__ = ["cnn", "data", "estimator", "nn", "rnn"]
