"""Data iterators (the port of `mxnet_tpu.io.io`): `DataDesc`,
`DataBatch`, the `DataIter` protocol, `NDArrayIter`, `ResizeIter`,
`PrefetchingIter` and `LibSVMIter`.

Batches are made on the current context (`gpu(0)` unless the caller
enters another, e.g. ``with mx.cpu():``), as the reference makes them on
its default one. `LibSVMIter` parses its file once, when it is made, into
flat numpy arrays (labels, the rows' offsets, column ids and values), so
that `next()` only slices them and copies one CSR batch to the device;
the reference keeps per-row Python lists and builds each batch from
them. The batches are the same: 0- or 1-based ids are kept as written,
``label_libsvm`` replaces the labels, and with ``round_batch`` the last
batch wraps around to the first rows and reports them in ``pad``.
"""
from __future__ import annotations

import queue
import threading
from collections import namedtuple

import numpy as np
import torch

from ..ndarray import sparse as _sp
from ..ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """The name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), np.dtype(dtype),
                               layout)


class DataBatch:
    """One batch: lists of data and label arrays, and `pad`, the number of
    wrapped rows at its end."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator protocol: reset / next / iter_next / getdata /
    getlabel / getindex / getpad."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, default_name):
    """[(name, NDArray)] from an array, a list or a dict of arrays; a
    float64 numpy array becomes float32, other numpy arrays keep their
    dtype."""
    if data is None:
        return []
    if isinstance(data, (NDArray, np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {("%s_%d" % (default_name, i)) if len(data) > 1 else
                default_name: d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, np.ndarray):
            v = array(v, dtype=v.dtype if v.dtype != np.float64 else None)
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Batches of in-memory arrays, optionally shuffled (`shuffle_seed`),
    the last one padded by wrapping around ("pad") or dropped
    ("discard")."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 shuffle_seed=None, last_batch_handle="pad",
                 data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, data_name)
        self.label = _init_data(label, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle
        self.cursor = -batch_size
        self._order = np.arange(self.num_data)
        if shuffle:
            self._rng = np.random.RandomState(shuffle_seed)
            self._rng.shuffle(self._order)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            self._rng.shuffle(self._order)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrs):
        idx = self._order[self.cursor:self.cursor + self.batch_size]
        if len(idx) < self.batch_size and self.last_batch_handle == "pad":
            idx = np.concatenate([idx, self._order[:self.batch_size
                                                   - len(idx)]])
        out = []
        for _, v in arrs:
            rows = torch.as_tensor(idx, device=v._data.device)
            out.append(NDArray(v._data.detach()[rows], ctx=v.context))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """`data_iter` resized to `size` batches an epoch (restarted when it
    runs out)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


class PrefetchingIter(DataIter):
    """Batches of one or more iterators made ahead by a background thread
    (two in flight); several iterators' batches are joined into one."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self._queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])

    def _start(self):
        def worker():
            try:
                while not self._stop.is_set():
                    self._queue.put([i.next() for i in self.iters])
            except StopIteration:
                self._queue.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def reset(self):
        self._stop.set()
        # the worker may be blocked on a full queue: empty it until it
        # sees the stop flag and leaves
        while self._thread.is_alive():
            self._drain()
            self._thread.join(timeout=0.05)
        self._drain()
        for i in self.iters:
            i.reset()
        self._stop.clear()
        self._start()

    def next(self):
        batches = self._queue.get()
        if batches is None:
            raise StopIteration
        b = batches[0]
        if len(batches) > 1:
            return DataBatch(data=sum([x.data for x in batches], []),
                             label=sum([x.label for x in batches], []),
                             pad=b.pad)
        return b

    def iter_next(self):
        raise NotImplementedError


def _parse_libsvm(path):
    """(labels, row offsets, column ids, values) of a libsvm file: one
    ``label id:value ...`` line a row, blank lines skipped."""
    labels, indptr, cols, vals = [], [0], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                i, v = tok.split(":")
                cols.append(int(i))
                vals.append(float(v))
            indptr.append(len(cols))
    return (np.asarray(labels, np.float32), np.asarray(indptr, np.int64),
            np.asarray(cols, np.int32), np.asarray(vals, np.float32))


class LibSVMIter(DataIter):
    """CSR data batches from a libsvm file (``label id:value ...`` a line,
    ids as written, `data_shape` the feature count), the labels from its
    first column or from `label_libsvm`'s."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=None, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        shape = (data_shape,) if isinstance(data_shape, int) \
            else tuple(data_shape)
        self._dim = shape[-1]
        self._labels, self._indptr, self._cols, self._vals = \
            _parse_libsvm(data_libsvm)
        if label_libsvm is not None:
            # the first token of each line is the label; the rest is
            # ignored
            labels = _parse_libsvm(label_libsvm)[0]
            if len(labels) != len(self._labels):
                raise ValueError("label_libsvm has %d rows but data has %d"
                                 % (len(labels), len(self._labels)))
            self._labels = labels
        self._num = len(self._labels)
        self.cursor = -batch_size
        self.round_batch = round_batch
        self.num_batches = (self._num + batch_size - 1) // batch_size

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._dim), np.float32)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,), np.float32)]

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self._num

    def next(self):
        if not self.iter_next():
            raise StopIteration
        sel = np.arange(self.cursor, min(self.cursor + self.batch_size,
                                         self._num))
        pad = self.batch_size - len(sel)
        if pad and self.round_batch:
            # wrap around to the first rows (modulo: a file shorter than a
            # batch)
            sel = np.concatenate([sel, np.arange(pad) % self._num])
        starts, lens = self._indptr[sel], np.diff(self._indptr)[sel]
        indptr = np.concatenate([[0], np.cumsum(lens)])
        pos = np.repeat(starts - indptr[:-1], lens) + np.arange(indptr[-1])
        csr = _sp.csr_matrix(
            (self._vals[pos], self._cols[pos], indptr.astype(np.int32)),
            shape=(len(sel), self._dim))
        return DataBatch(data=[csr], label=[array(self._labels[sel])],
                         pad=pad if self.round_batch else 0)
