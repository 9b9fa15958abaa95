"""Gluon of the port: blocks, parameters, the ResNet layers, the fused
conv blocks, the vision model zoo's ResNets, the losses, `Trainer`,
`FusedTrainStep`, `data` (datasets, samplers, the DataLoader, the vision
datasets and transforms), `utils`, `contrib.estimator` and `contrib.rnn`,
`SymbolBlock` with `HybridBlock.export`, and `rnn` (the recurrent cells
and the fused RNN, LSTM and GRU layers)."""
from . import block, contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .fused_step import FusedTrainStep
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Constant", "DeferredInitializationError",
           "Parameter", "ParameterDict", "Trainer", "FusedTrainStep",
           "contrib", "data", "loss", "model_zoo", "nn", "rnn", "utils"]
