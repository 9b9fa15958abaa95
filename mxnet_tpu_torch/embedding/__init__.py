"""`mx.embedding`: vocab-sharded embedding tables (the port of
`mxnet_tpu.embedding`).

* `ShardedEmbedding` (`table.py`): a table sharded over the ranks on the
  vocab axis, with lookups, the sparse update of the touched rows
  (optimizer state beside the owned rows only) and world-size-independent
  checkpoints.
* `ops.sparse_ops.segment_sum`: the scatter-add under every dedup and
  update, kernel #11 on a card.
* `EmbeddingLookupService` (`serving.py`): fixed-bucket gathers over a
  table snapshot that answer the kvstore's `row_sparse_pull`; after
  warm-up, steady traffic counts no ``serve.retrace``.

Quickstart::

    from mxnet_tpu_torch.embedding import ShardedEmbedding

    table = ShardedEmbedding(vocab=1_000_000, dim=64, optimizer="adam")
    rows = table.lookup(ids)             # (batch, dim)
    ...                                  # a loss over rows
    table.apply_grads(ids, grad_rows)    # dedup + owned-row update

The mesh comm (`MeshEmbeddingComm`) comes with the port's multi-rank
communication slice.
"""
from .serving import EmbeddingLookupService
from .table import EmbeddingComm, ShardedEmbedding

__all__ = ["ShardedEmbedding", "EmbeddingComm", "EmbeddingLookupService"]
