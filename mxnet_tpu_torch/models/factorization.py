"""Factorization models on the port's sparse Gluon path.

- The factorization machine (BASELINE config 4, "Sparse NDArray +
  factorization-machine, rowsparse push/pull on the PS path"): CSR batches
  from `io.LibSVMIter`, three CSR dots under `autograd.record`, the
  logistic loss, the row-sparse gradients of the rows a batch touched
  pushed to a store that runs AdaGrad, those rows pulled back into the
  dense replicas, and the bias by plain SGD. The loop is the reference's
  own (its `tests/test_sparse.py::test_factorization_machine_end_to_end`).
- Matrix factorization through Gluon: `MFNet` (four
  `Embedding(sparse_grad=True)` tables, a dot-product score plus biases;
  the reference's `examples/matrix_factorization.py`).

Seeded data for both (Criteo-layout libsvm files, low-rank ratings) is in
`test_utils`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import ndarray as nd
from ..gluon import HybridBlock, nn
from ..ndarray import sparse as sp

__all__ = ["fm_init", "fm_forward", "fm_store", "fm_step", "MFNet"]

# AdaGrad's rate on the store, and the bias's SGD rate (the reference
# loop's). The reference's miniature FM (2-6 nonzeros a row) takes
# AdaGrad lr 0.5; with Criteo's 39 that first step, lr times the
# gradient's sign on every touched row, overflows the pairwise term.
FM_LR, FM_BIAS_LR = 0.01, 0.1


def fm_init(num_features, factor_size, seed=0):
    """The FM's dense replicas on the current context, each with a
    gradient buffer: the linear weights w (num_features, 1) at zero, the
    factors v (num_features, factor_size) drawn N(0, 0.05) from `seed`,
    the bias b (1,) at zero."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(num_features, factor_size) * 0.05).astype(np.float32)
    params = (nd.zeros((num_features, 1)), nd.array(v), nd.zeros((1,)))
    for p in params:
        p.attach_grad()
    return params


def fm_store(kv, w, v, batch_size, learning_rate=FM_LR):
    """Put w and v into the store `kv` (keys 0 and 1) and make it run
    AdaGrad at `learning_rate` on them, the gradients scaled by 1 /
    batch_size."""
    from .. import optimizer
    kv.init(0, w)
    kv.init(1, v)
    kv.set_optimizer(optimizer.create(
        "adagrad", learning_rate=learning_rate,
        rescale_grad=1.0 / batch_size))


def fm_forward(csr, csr_sq, w, v, b):
    """The FM's logit: x.w + 0.5 * sum((x.v)^2 - x^2.v^2) + b."""
    lin = sp.dot(csr, w)
    xv = sp.dot(csr, v)
    x2v2 = sp.dot(csr_sq, nd.square(v))
    pair = 0.5 * nd.sum(nd.square(xv) - x2v2, axis=1, keepdims=True)
    return lin + pair + b


def fm_step(kv, batch, w, v, b, batch_size, bias_lr=FM_BIAS_LR):
    """One step of the reference's loop on a `LibSVMIter` batch: forward
    and logistic loss under `autograd.record`, backward, the touched rows'
    gradients (times batch_size, which the store's rescale undoes) pushed
    as row-sparse arrays, the same rows pulled back into w and v, the bias
    by SGD at `bias_lr`, the gradients zeroed. Returns the loss (an
    NDArray)."""
    csr = batch.data[0]
    ctx = csr.context
    sq = sp.CSRNDArray(csr._sp_data * csr._sp_data, csr._sp_indices,
                       csr._indptr, csr.shape, ctx=ctx)
    y = batch.label[0].reshape((-1, 1))
    with autograd.record():
        out = fm_forward(csr, sq, w, v, b)
        loss = nd.mean(nd.log(1 + nd.exp(-(2 * y - 1) * out)))
    loss.backward()
    # only the rows this batch touched travel (a host unique, as in the
    # reference's loop)
    touched = np.unique(csr._sp_indices.cpu().numpy())
    rows = torch.as_tensor(touched, device=ctx.torch_device)
    for key, param in ((0, w), (1, v)):
        grad = param.grad._data[rows.long()] * batch_size
        kv.push(key, sp.RowSparseNDArray(grad, rows, param.shape, ctx=ctx))
    for key, param in ((0, w), (1, v)):
        pulled = sp.zeros("row_sparse", param.shape, ctx=ctx)
        kv.row_sparse_pull(key, out=pulled, row_ids=nd.NDArray(rows, ctx=ctx))
        with torch.no_grad():
            param._data[pulled._indices.long()] = pulled._values
    with torch.no_grad():
        b._data.sub_(bias_lr * b.grad._data)
    for p in (w, v, b):
        p.zero_grad()
    return loss


class MFNet(HybridBlock):
    """score(u, i) = <user[u], item[i]> + user_b[u] + item_b[i], each table
    an `Embedding` with a row-sparse gradient."""

    def __init__(self, n_users, n_items, k=16, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.user = nn.Embedding(n_users, k, sparse_grad=True)
            self.item = nn.Embedding(n_items, k, sparse_grad=True)
            self.user_b = nn.Embedding(n_users, 1, sparse_grad=True)
            self.item_b = nn.Embedding(n_items, 1, sparse_grad=True)

    def hybrid_forward(self, F, user, item):
        p, q = self.user(user), self.item(item)
        score = F.sum(p * q, axis=-1)
        return score + self.user_b(user).reshape((-1,)) \
            + self.item_b(item).reshape((-1,))

