"""Automatic mixed precision. reference: python/mxnet/contrib/amp/amp.py."""
from .amp import (init, init_trainer, scale_loss, unscale, convert_model,
                  LossScaler, list_lp16_ops, list_fp32_ops)

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "LossScaler", "list_lp16_ops", "list_fp32_ops"]
