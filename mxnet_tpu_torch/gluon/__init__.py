"""Gluon of the port: blocks, parameters, the ResNet layers, the fused
conv blocks, the vision model zoo's ResNets, the losses, `Trainer` and
`FusedTrainStep`."""
from . import block, contrib, loss, model_zoo, nn
from .block import Block, HybridBlock
from .fused_step import FusedTrainStep
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Constant", "DeferredInitializationError",
           "Parameter", "ParameterDict", "Trainer", "FusedTrainStep",
           "contrib", "loss", "model_zoo", "nn"]
