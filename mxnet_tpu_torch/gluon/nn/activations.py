"""Activation blocks (the port of `mxnet_tpu.gluon.nn.activations`'s
Activation and GELU)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "GELU"]


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "{name}({act})".format(name=self.__class__.__name__,
                                      act=self._act_type)


class GELU(HybridBlock):
    """x * Phi(x) with the exact (erf) Gaussian CDF, as the reference's."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
