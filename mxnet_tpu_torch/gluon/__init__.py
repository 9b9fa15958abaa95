"""Gluon of the port: blocks, parameters, the ResNet layers, the fused
conv blocks and the vision model zoo's ResNets (inference)."""
from . import block, contrib, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)

__all__ = ["Block", "HybridBlock", "Constant", "DeferredInitializationError",
           "Parameter", "ParameterDict", "contrib", "model_zoo", "nn"]
