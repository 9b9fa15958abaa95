"""Datasets (the port of `mxnet_tpu.gluon.data.dataset`).

`Dataset` with `transform`, `transform_first`, `filter`, `shard`, `take`
and `sample`; `SimpleDataset`, `ArrayDataset` and the base of the vision
datasets, `_DownloadedDataset`. The transform wrappers are module-level
classes, so a dataset pickles into the DataLoader's spawned workers.
`RecordFileDataset` reads a RecordIO pack through its .idx; its reader
pickles closed and reopens the file in the worker that reads it.
"""
from __future__ import annotations

import os

from ... import ndarray as nd

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "_DownloadedDataset"]


class Dataset:
    """Abstract dataset: `__getitem__` and `__len__`."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which fn(sample) is true."""
        from .sampler import FilterSampler
        return _SampledDataset(self, FilterSampler(fn, self))

    def shard(self, num_shards, index):
        """The index-th of num_shards contiguous parts; the first
        len % num_shards parts hold one sample more."""
        assert index < num_shards, \
            "Shard index of out bound: %d out of %d" % (index, num_shards)
        assert num_shards > 0
        assert index >= 0
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _SampledDataset(self, _RangeSampler(start, end))

    def take(self, count):
        """The first `count` samples (all of them for None)."""
        if count is None or count > len(self):
            count = len(self)
        return _SampledDataset(self, _RangeSampler(0, count))

    def sample(self, sampler):
        return _SampledDataset(self, sampler)

    def transform(self, fn, lazy=True):
        """fn applied to each sample (to its fields, for a tuple): at each
        access when `lazy`, else once, now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """fn applied to the first field of each sample only."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A dataset over a list or an array."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    """fn on the first field; picklable, for the spawned workers."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _SampledDataset(Dataset):
    def __init__(self, dataset, sampler):
        self._dataset = dataset
        self._sampler = sampler
        self._indices = list(iter(sampler))

    def __len__(self):
        return len(self._sampler)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class _RangeSampler:
    def __init__(self, start, end):
        self._start = start
        self._end = end

    def __iter__(self):
        return iter(range(self._start, self._end))

    def __len__(self):
        return self._end - self._start


class ArrayDataset(Dataset):
    """The samples of several arrays of one length, zipped; a 1-D NDArray
    is read as numpy, so its samples are scalars."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has length " \
                "%d while array[%d] has %d." % (self._length, i + 1,
                                                len(data))
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of a RecordIO file, as bytes, in the order of its .idx
    (``splitext(filename)[0] + ".idx"``, rebuilt by the framing scan where
    it is missing). reference: data/dataset.py (RecordFileDataset)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = MXIndexedRecordIO(self.idx_file, self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)


class _DownloadedDataset(Dataset):
    """Base of the datasets kept in a root directory (MNIST, CIFAR). The
    port has no network: `_get_data` reads the files in `root`, or makes
    the reference's seeded synthetic samples where they are absent. The
    samples stay on the host (`cpu()`), whatever the default context."""

    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError
