"""Seeded data for tests and the smoke runs of the sparse Gluon and MNIST
paths.

- `criteo_ids` / `criteo_libsvm`: feature ids and libsvm files of the
  Criteo display-ad layout, as the LIBSVM datasets page publishes it (13
  integer and 26 categorical fields, one nonzero each), for the
  factorization machine.
- `synthetic_ratings`: low-rank ratings for matrix factorization (the
  reference's `examples/matrix_factorization.py`).
- `synthetic_mnist` / `write_mnist`: MNIST-shaped digits (class templates
  plus noise, as the vision datasets' synthetic fallback draws them, but
  train and test from one template set) and the idx files that
  `gluon.data.vision.MNIST` reads.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = ["CRITEO_FIELDS", "criteo_ids", "criteo_libsvm",
           "synthetic_ratings", "synthetic_mnist", "write_mnist"]

# ids are drawn zipf(1.2) within a field
CRITEO_FIELDS = 13 + 26
CRITEO_ZIPF = 1.2


def criteo_ids(rng, rows, num_features):
    """(rows, 39) feature ids of Criteo's layout: each field takes a
    disjoint range of `num_features` // 39 ids and one id a row, drawn
    zipf(1.2) within its range (so ids ascend along a row)."""
    span = num_features // CRITEO_FIELDS
    return (rng.zipf(CRITEO_ZIPF, size=(rows, CRITEO_FIELDS)) - 1) % span \
        + np.arange(CRITEO_FIELDS) * span


def criteo_libsvm(path, rows, num_features, seed=0):
    """Write `rows` seeded lines of Criteo's layout (`criteo_ids`) to
    `path`, values in [0, 1); the label says whether a hidden linear model
    of the row is positive."""
    rng = np.random.RandomState(seed)
    ids = criteo_ids(rng, rows, num_features)
    vals = rng.rand(rows, CRITEO_FIELDS).astype(np.float32)
    w_true = rng.randn(num_features).astype(np.float32)
    labels = ((w_true[ids] * vals).sum(axis=1) > 0).astype(np.int64)
    with open(path, "w") as f:
        for y, i_row, v_row in zip(labels, ids, vals):
            f.write("%d %s\n" % (y, " ".join(
                "%d:%.4f" % (i, v) for i, v in zip(i_row, v_row))))


def synthetic_ratings(n_users, n_items, n_obs, k=8, noise=0.1, seed=0):
    """Seeded low-rank ratings: (users, items, ratings, the noise floor of
    the MSE)."""
    rng = np.random.RandomState(seed)
    U = rng.normal(0, 1.0 / np.sqrt(k), (n_users, k)).astype(np.float32)
    V = rng.normal(0, 1.0 / np.sqrt(k), (n_items, k)).astype(np.float32)
    users = rng.randint(0, n_users, n_obs).astype(np.int32)
    items = rng.randint(0, n_items, n_obs).astype(np.int32)
    ratings = (U[users] * V[items]).sum(-1) + \
        rng.normal(0, noise, n_obs).astype(np.float32)
    return users, items, ratings.astype(np.float32), noise ** 2


def synthetic_mnist(num_train, num_test, seed=0, shape=(28, 28),
                    num_classes=10):
    """(train images, train labels, test images, test labels): uint8
    images of `shape`, each a class template plus noise in [-40, 40), the
    templates shared by train and test, uint8 labels."""
    rng = np.random.RandomState(seed)
    templates = rng.randint(0, 255, size=(num_classes,) + shape)
    out = []
    for n in (num_train, num_test):
        labels = rng.randint(0, num_classes, size=(n,))
        noise = rng.randint(-40, 40, size=(n,) + shape)
        out += [np.clip(templates[labels] + noise, 0, 255).astype(np.uint8),
                labels.astype(np.uint8)]
    return tuple(out)


def write_mnist(root, images, labels, train=True):
    """Write uint8 (n, 28, 28) images and their labels into `root` as the
    gzipped idx files of MNIST's train (or t10k) split."""
    prefix = "train" if train else "t10k"
    n, rows, cols = images.shape
    with gzip.open(os.path.join(root, "%s-images-idx3-ubyte.gz" % prefix),
                   "wb", compresslevel=1) as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols))
        f.write(np.ascontiguousarray(images, dtype=np.uint8).tobytes())
    with gzip.open(os.path.join(root, "%s-labels-idx1-ubyte.gz" % prefix),
                   "wb", compresslevel=1) as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(np.ascontiguousarray(labels, dtype=np.uint8).tobytes())
