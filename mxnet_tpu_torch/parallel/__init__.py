"""Attention kernels, the functional trainer and its checkpoints."""
from .checkpoint import latest_step, restore_train_state, save_train_state
from .flash_attention import (flash_attention, paged_attention,
                              paged_attention_chunk)
from .train_step import ShardedTrainStep, adam_init, sgd_init

__all__ = ["flash_attention", "paged_attention", "paged_attention_chunk",
           "ShardedTrainStep", "adam_init", "sgd_init", "save_train_state",
           "restore_train_state", "latest_step"]
