"""`gluon.contrib` of the port: the fused conv blocks (`cnn`),
`IntervalSampler` (`data`), the `Estimator` (`estimator`) and the
recurrent cells of `rnn`."""
from . import cnn
from . import data
from . import estimator
from . import rnn

__all__ = ["cnn", "data", "estimator", "rnn"]
