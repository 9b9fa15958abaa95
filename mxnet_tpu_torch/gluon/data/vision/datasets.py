"""Vision datasets (the port of `mxnet_tpu.gluon.data.vision.datasets`).

MNIST and FashionMNIST read the idx files (``*-idx?-ubyte.gz``) in
`root`, CIFAR10 and CIFAR100 the binary batches. Where the files are
absent, each makes the reference's seeded synthetic samples
(`_synthetic_images`, the same seeds and so the same bytes). The port has
no network and downloads nothing. The samples stay on the host (`cpu()`):
the port's default context is the card, and a dataset on it would make
every sample a device slice.

`ImageRecordDataset` decodes the records of a .rec pack, and
`ImageFolderDataset` the images of root/category/ (JPEG and PNG through
PIL, ``.npy`` with numpy), each image to an HWC array on `cpu()`.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from .... import ndarray as nd
from ....context import cpu
from ....recordio import unpack as rec_unpack
from ..dataset import Dataset, _DownloadedDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _synthetic_images(num, shape, num_classes, seed):
    """Deterministic class-structured synthetic data: each class is a fixed
    random template plus noise, so classifiers can actually learn."""
    rng = _np.random.RandomState(seed)
    templates = rng.randint(0, 255, size=(num_classes,) + shape)
    labels = rng.randint(0, num_classes, size=(num,))
    noise = rng.randint(-40, 40, size=(num,) + shape)
    data = _np.clip(templates[labels] + noise, 0, 255).astype("uint8")
    return data, labels.astype("int32")


class MNIST(_DownloadedDataset):
    """MNIST (idx format). reference: vision/datasets.py (MNIST)."""

    _TRAIN = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _TEST = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")
    _SHAPE = (28, 28, 1)
    _CLASSES = 10
    _SYN_COUNT = (8192, 1024)

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        img_file, lbl_file = self._TRAIN if self._train else self._TEST
        img_path = os.path.join(self._root, img_file)
        lbl_path = os.path.join(self._root, lbl_file)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = _np.frombuffer(fin.read(), dtype=_np.uint8) \
                    .astype(_np.int32)
            with gzip.open(img_path, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = _np.frombuffer(fin.read(), dtype=_np.uint8)
                data = data.reshape(len(label), 28, 28, 1)
        else:
            n = self._SYN_COUNT[0] if self._train else self._SYN_COUNT[1]
            data, label = _synthetic_images(n, self._SHAPE, self._CLASSES,
                                            seed=42 if self._train else 43)
        self._data = nd.array(data, ctx=cpu(), dtype=data.dtype)
        self._label = label


class FashionMNIST(MNIST):
    """reference: vision/datasets.py (FashionMNIST)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 (binary batches). reference: vision/datasets.py (CIFAR10)."""

    _SHAPE = (32, 32, 3)
    _CLASSES = 10
    _SYN_COUNT = (8192, 1024)

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._archive_file_name = "cifar-10-binary.tar.gz"
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(
                -1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(_np.int32)

    def _get_data(self):
        if self._train:
            filename = [os.path.join(self._root,
                                     "data_batch_%d.bin" % (i + 1))
                        for i in range(5)]
        else:
            filename = [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in filename):
            data, label = zip(*(self._read_batch(f) for f in filename))
            data = _np.concatenate(data)
            label = _np.concatenate(label)
        else:
            n = self._SYN_COUNT[0] if self._train else self._SYN_COUNT[1]
            data, label = _synthetic_images(n, self._SHAPE, self._CLASSES,
                                            seed=44 if self._train else 45)
        self._data = nd.array(data, ctx=cpu(), dtype=data.dtype)
        self._label = label


class CIFAR100(CIFAR10):
    """reference: vision/datasets.py (CIFAR100)."""

    _CLASSES = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), fine_label=False,
                 train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(
                -1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(_np.int32)

    def _get_data(self):
        if self._train:
            filename = [os.path.join(self._root, "train.bin")]
        else:
            filename = [os.path.join(self._root, "test.bin")]
        if all(os.path.exists(f) for f in filename):
            data, label = zip(*(self._read_batch(f) for f in filename))
            data = _np.concatenate(data)
            label = _np.concatenate(label)
        else:
            n = self._SYN_COUNT[0] if self._train else self._SYN_COUNT[1]
            data, label = _synthetic_images(n, self._SHAPE, self._CLASSES,
                                            seed=46 if self._train else 47)
        self._data = nd.array(data, ctx=cpu(), dtype=data.dtype)
        self._label = label


class ImageRecordDataset(Dataset):
    """(image, label) pairs of a .rec image pack: the image an HWC uint8
    array on `cpu()`, the label the record header's.
    reference: vision/datasets.py (ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from ....image import imdecode
        header, img = rec_unpack(self._record[idx])
        img = nd.array(imdecode(img, self._flag, to_ndarray=False),
                       ctx=cpu(), dtype="uint8")
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """(image, label) pairs of the images in root/category/ (``.jpg``,
    ``.jpeg``, ``.png`` and ``.npy``), the label being the category's rank
    among the sorted folder names; images on `cpu()` (uint8, or float32
    for ``.npy`` as the reference loads them).
    reference: vision/datasets.py (ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = nd.array(_np.load(path), ctx=cpu())
        else:
            with cpu():
                img = imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
