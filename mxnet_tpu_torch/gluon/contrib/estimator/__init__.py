"""`gluon.contrib.estimator` of the port: the `Estimator` fit loop and its
event handlers."""
from .estimator import Estimator
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, ValidationHandler,
                            LoggingHandler, CheckpointHandler,
                            EarlyStoppingHandler)

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]
