"""`gluon.contrib.cnn` of the port: the fused conv3x3 + BN + ReLU
blocks."""
from .conv_layers import FusedConvBNReLU, FusedConvBNReLUTrain

__all__ = ["FusedConvBNReLU", "FusedConvBNReLUTrain"]
