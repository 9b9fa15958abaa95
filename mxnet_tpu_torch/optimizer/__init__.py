"""Optimizers of the port: SGD and Adam, the registry and the Updater."""
from . import optimizer
from .optimizer import *  # noqa: F401,F403
from .optimizer import (Optimizer, Updater, create, get_updater,
                        register)

__all__ = optimizer.__all__
