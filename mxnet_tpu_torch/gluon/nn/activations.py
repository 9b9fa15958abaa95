"""Activation blocks (the port of `mxnet_tpu.gluon.nn.activations`):
Activation, LeakyReLU, PReLU, ELU, SELU, Swish and GELU, all but Swish
through the `LeakyReLU` op's modes."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


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


class LeakyReLU(HybridBlock):
    """max(x, alpha * x) with a fixed slope alpha >= 0."""

    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise ValueError("Slope coefficient for LeakyReLU must be no "
                             "less than 0.")
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "{name}({alpha})".format(name=self.__class__.__name__,
                                        alpha=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope: one parameter ``alpha`` of shape
    (1,), 0.25 by default."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """x for x > 0, alpha * (exp(x) - 1) otherwise."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """x * Phi(x) with the exact (erf) Gaussian CDF, as the reference's."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
