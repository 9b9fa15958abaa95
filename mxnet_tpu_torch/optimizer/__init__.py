"""Optimizers of the port: SGD, Adam and LAMB, the registry, the Updater
and the ZeRO updater."""
from . import optimizer, zero
from .optimizer import *  # noqa: F401,F403
from .optimizer import (Optimizer, Updater, create, get_updater,
                        register)
from .zero import ZeroComm, ZeroUpdater, zero_enabled

__all__ = optimizer.__all__ + ["ZeroComm", "ZeroUpdater", "zero_enabled"]
