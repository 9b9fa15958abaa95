"""`gluon.data` of the port: datasets, samplers, the DataLoader and the
vision datasets and transforms."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401

from . import dataset, sampler, dataloader

__all__ = dataset.__all__ + sampler.__all__ + dataloader.__all__ + ["vision"]
