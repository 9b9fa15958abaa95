"""`gluon.contrib.nn` of the port: Concurrent, HybridConcurrent and
Identity (the `gluon.nn` classes), SparseEmbedding and SyncBatchNorm."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding, SyncBatchNorm)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]
