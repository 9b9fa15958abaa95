"""The layers of `gluon.contrib.nn` (the port of
`mxnet_tpu.gluon.contrib.nn.basic_layers`)."""
from __future__ import annotations

from ...block import Block
from ...nn import BatchNorm, Concurrent, HybridConcurrent, Identity

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class SparseEmbedding(Block):
    """Index -> vector lookup whose weight gradient is row-sparse: the rows
    the batch looked up, merged as `autograd` merges them, for a
    `Trainer` or kvstore that pushes and pulls rows."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": True}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), init=weight_initializer,
            dtype=dtype, grad_stype="row_sparse")

    def forward(self, x):
        from .... import ndarray as nd
        return nd.Embedding(x, self.weight.data(x.context), **self._kwargs)

    def __repr__(self):
        return "{block_name}({input_dim} -> {output_dim}, {dtype})".format(
            block_name=self.__class__.__name__, **self._kwargs)


class SyncBatchNorm(BatchNorm):
    """BatchNorm whose batch statistics span every device. It is
    `BatchNorm` over axis 1, as in the reference, where GSPMD makes the base
    BatchNorm global: inside a data-parallel `gluon.FusedTrainStep` over
    several ranks every training-mode BatchNorm normalizes with the global
    batch's statistics (all-reduced over the batch ranks) and writes the
    same running statistics on every rank; elsewhere (one rank, a
    `Trainer` over a dist store, where each reference process also runs
    its own forward) it uses this rank's batch. `num_devices` and `key`
    are accepted and not read, as in the reference."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", key=None, **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
