"""`gluon.data.vision` of the port: MNIST, FashionMNIST, CIFAR10/100 and
the transforms."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401
from . import datasets

__all__ = datasets.__all__ + ["transforms"]
