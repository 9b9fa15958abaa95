"""`gluon.contrib` of the port: the fused conv blocks (`cnn`),
`IntervalSampler` (`data`) and the `Estimator` (`estimator`)."""
from . import cnn
from . import data
from . import estimator

__all__ = ["cnn", "data", "estimator"]
