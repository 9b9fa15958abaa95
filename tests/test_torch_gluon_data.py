"""The port's `gluon.data` against the JAX package's.

Samplers, dataset transforms and the DataLoader move values without
arithmetic, so every comparison is exact: the same indices in the same
order under one `np.random.seed`, and the same batches, whether the port
builds them in the main process, in two spawned workers or in a thread
pool. The vision datasets read the same files (written here, in the byte
formats the reference reads) into equal arrays, and make the same
synthetic bytes where the files are absent.
"""
import os
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.test_utils import synthetic_mnist, write_mnist

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(i) for i in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _shm():
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def _no_new_segment(before):
    """No shared-memory segment beyond `before` stays. Other test
    processes may hold a segment for a moment: wait up to 5 s for theirs
    to go; a leaked one stays for good."""
    import time
    for _ in range(50):
        if not _shm() - before:
            return True
        time.sleep(0.1)
    return False


# -- samplers ---------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 10, 37])
def test_random_sampler_same_order_under_one_seed(length):
    orders = []
    for pkg in (mx, jmx):
        np.random.seed(123)
        s = pkg.gluon.data.RandomSampler(length)
        orders.append([list(s), list(s)])
        assert len(s) == length
    assert orders[0] == orders[1]
    assert sorted(orders[0][0]) == list(range(length))


def test_sequential_and_filter_samplers():
    for pkg in (mx, jmx):
        s = pkg.gluon.data.SequentialSampler(5, start=3)
        assert list(s) == [3, 4, 5, 6, 7] and len(s) == 5
    ds = list(range(20))
    mine = mx.gluon.data.FilterSampler(lambda v: v % 3 == 0, ds)
    ref = jmx.gluon.data.FilterSampler(lambda v: v % 3 == 0, ds)
    assert list(mine) == list(ref) and len(mine) == len(ref)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("length,batch", [(10, 3), (12, 4), (5, 7)])
def test_batch_sampler(last_batch, length, batch):
    got = []
    for pkg in (mx, jmx):
        np.random.seed(7)
        bs = pkg.gluon.data.BatchSampler(pkg.gluon.data.RandomSampler(length),
                                         batch, last_batch)
        # two epochs: rollover carries the first epoch's tail over
        got.append([list(bs), len(bs), list(bs), len(bs)])
    assert got[0] == got[1]


def test_batch_sampler_rejects_unknown_last_batch():
    bs = mx.gluon.data.BatchSampler(mx.gluon.data.SequentialSampler(5), 2,
                                    "pad")
    with pytest.raises(ValueError):
        list(bs)
    with pytest.raises(ValueError):
        len(bs)


@pytest.mark.parametrize("length,interval,rollover",
                         [(10, 3, True), (10, 3, False), (9, 9, True),
                          (7, 1, False)])
def test_interval_sampler(length, interval, rollover):
    from mxnet_tpu.gluon.contrib.data import IntervalSampler as Ref
    from mxnet_tpu_torch.gluon.contrib.data import IntervalSampler
    mine = IntervalSampler(length, interval, rollover)
    ref = Ref(length, interval, rollover)
    assert list(mine) == list(ref) and len(mine) == len(ref)


# -- datasets ---------------------------------------------------------------

def _arrays(seed=0, n=23):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 5, n).astype(np.int32))


def _double(x):
    return x * 2


def _pair(x, y):
    return x + 1, y * 3


@pytest.mark.parametrize("op", ["plain", "transform", "transform_eager",
                                "transform_first", "filter", "shard", "take",
                                "take_none", "sample"])
def test_dataset_transforms(op):
    x, y = _arrays()
    got = []
    for pkg in (mx, jmx):
        ds = pkg.gluon.data.ArrayDataset(x, y)
        if op == "transform":
            ds = ds.transform(_pair)
        elif op == "transform_eager":
            ds = ds.transform(_pair, lazy=False)
        elif op == "transform_first":
            ds = ds.transform_first(_double)
        elif op == "filter":
            ds = ds.filter(lambda s: s[1] % 2 == 0)
        elif op == "take":
            ds = ds.take(7)
        elif op == "take_none":
            ds = ds.take(None)
        elif op == "sample":
            ds = ds.sample(pkg.gluon.data.SequentialSampler(5, start=4))
        if op == "shard":
            parts = [ds.shard(4, i) for i in range(4)]
            got.append([[tuple(np.asarray(v) for v in p[i])
                         for i in range(len(p))] for p in parts])
        else:
            got.append([tuple(np.asarray(v) for v in ds[i])
                        for i in range(len(ds))])
    assert len(got[0]) == len(got[1])
    for a, b in zip(got[0], got[1]):
        if op == "shard":
            assert len(a) == len(b)
            for s1, s2 in zip(a, b):
                for u, v in zip(s1, s2):
                    np.testing.assert_array_equal(u, v)
        else:
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_simple_and_array_dataset_of_ndarrays():
    x, y = _arrays(n=6)
    ds = mx.gluon.data.ArrayDataset(mx.nd.array(x), mx.nd.array(y))
    ref = jmx.gluon.data.ArrayDataset(jmx.nd.array(x), jmx.nd.array(y))
    for i in range(6):
        _same(ds[i][0], ref[i][0])
        assert float(ds[i][1]) == float(ref[i][1])
    sd = mx.gluon.data.SimpleDataset([1, 2, 3])
    assert len(sd) == 3 and sd[2] == 3
    with pytest.raises(AssertionError):
        mx.gluon.data.ArrayDataset(x, y[:3])


def test_record_file_datasets_wait_for_queue_a7(tmp_path):
    """The three record datasets, which raised until the port had
    RecordIO and a decoder, open a pack and a folder written by the
    port."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.gluon.data.vision import (ImageFolderDataset,
                                                   ImageRecordDataset)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (3, 5, 6, 3), dtype=np.uint8)
    rec = str(tmp_path / "x.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "x.idx"), rec, "w")
    for i, img in enumerate(imgs):
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i), i, 0), img))
    w.close()
    raw = mx.gluon.data.RecordFileDataset(rec)
    assert len(raw) == 3
    np.testing.assert_array_equal(recordio.unpack_img(raw[1])[1], imgs[1])
    ds = ImageRecordDataset(rec)
    for i in range(3):
        img, label = ds[i]
        np.testing.assert_array_equal(img.asnumpy(), imgs[i])
        assert float(label) == i
    folder = tmp_path / "folder" / "only"
    folder.mkdir(parents=True)
    np.save(str(folder / "a.npy"), imgs[2])
    img, label = ImageFolderDataset(str(tmp_path / "folder"))[0]
    np.testing.assert_array_equal(img.asnumpy(), imgs[2])
    assert label == 0


# -- DataLoader -------------------------------------------------------------

class _Nested(mx.gluon.data.Dataset):
    """(image-like array, (label, weight)): a nested sample, picklable."""

    def __init__(self, n):
        rng = np.random.RandomState(1)
        self._x = rng.randint(0, 255, (n, 4, 5, 3)).astype(np.uint8)
        self._y = rng.randint(0, 10, n).astype(np.int32)

    def __len__(self):
        return len(self._y)

    def __getitem__(self, i):
        return (mx.nd.array(self._x[i], ctx=mx.cpu(), dtype="uint8"),
                (self._y[i], np.float32(i) / 7))


def _worker_state():
    import mxnet_tpu_torch as wmx
    return (torch.cuda.is_initialized(), str(wmx.current_context()),
            torch.get_num_threads())


def _loader_batches(ds, **kw):
    np.random.seed(5)
    loader = mx.gluon.data.DataLoader(ds, batch_size=6, shuffle=True,
                                      last_batch="rollover", **kw)
    batches = [list(loader), list(loader)]
    state = loader._pool.apply(_worker_state) if kw.get("num_workers") \
        else None
    del loader
    return batches, state


def test_dataloader_workers_and_threads_equal_the_main_process():
    """0 workers, 2 spawned workers and a thread pool give the same
    batches (nested tuples too), on the host, with no shared-memory
    segment left; the spawned workers run on the CPU, one torch thread
    each, without CUDA."""
    ds = _Nested(29)
    before = _shm()
    base, _ = _loader_batches(ds)
    spawned, state = _loader_batches(ds, num_workers=2)
    threaded, _ = _loader_batches(ds, num_workers=2, thread_pool=True)
    assert _no_new_segment(before)
    assert state == (False, "cpu(0)", 1)
    assert [len(e) for e in base] == [4, 5]   # 29 = 4 * 6 + 5, rolled over
    for other in (spawned, threaded):
        for e1, e2 in zip(base, other):
            assert len(e1) == len(e2)
            for b1, b2 in zip(e1, e2):
                _same(b1, b2)
    for batch in base[0] + spawned[0] + threaded[0]:
        x, (y, w) = batch
        for arr in (x, y, w):
            assert isinstance(arr, mx.nd.NDArray)
            assert arr.context == mx.cpu()
        assert x.dtype == np.uint8 and y.dtype == np.int32


def test_dataloader_matches_reference_batches():
    x, y = _arrays(n=31)
    got = []
    for pkg in (mx, jmx):
        np.random.seed(11)
        ds = pkg.gluon.data.ArrayDataset(x, y).transform_first(_double)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=8, shuffle=True)
        got.append(list(loader))
        assert len(loader) == 4
    for a, b in zip(*got):
        _same(a, b)


def test_abandoned_iterator_leaves_no_segment():
    ds = _Nested(40)
    before = _shm()
    loader = mx.gluon.data.DataLoader(ds, batch_size=4, num_workers=2)
    it = iter(loader)
    first = next(it)
    del it, loader
    assert _no_new_segment(before)
    assert first[0].shape == (4, 4, 5, 3)


class _Slow(mx.gluon.data.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        import time
        time.sleep(2.0)
        return np.float32(i)


def test_worker_that_hangs_raises_after_timeout():
    import multiprocessing
    loader = mx.gluon.data.DataLoader(_Slow(), batch_size=2, num_workers=1,
                                      thread_pool=True, timeout=0.2)
    it = iter(loader)
    with pytest.raises(multiprocessing.TimeoutError):
        next(it)


def test_unpicklable_dataset_is_refused_before_spawning():
    ds = mx.gluon.data.ArrayDataset(*_arrays()).transform(lambda a, b: a)
    with pytest.raises(ValueError, match="picklable"):
        mx.gluon.data.DataLoader(ds, batch_size=2, num_workers=2)


def test_dataloader_argument_checks():
    ds = mx.gluon.data.SimpleDataset(list(range(5)))
    with pytest.raises(ValueError):
        mx.gluon.data.DataLoader(ds)
    with pytest.raises(ValueError):
        mx.gluon.data.DataLoader(ds, batch_size=2, shuffle=True,
                                 sampler=mx.gluon.data.SequentialSampler(5))
    bs = mx.gluon.data.BatchSampler(mx.gluon.data.SequentialSampler(5), 2)
    with pytest.raises(ValueError):
        mx.gluon.data.DataLoader(ds, batch_size=2, batch_sampler=bs)
    loader = mx.gluon.data.DataLoader(ds, batch_sampler=bs, pin_memory=True)
    _same(list(loader), [mx.nd.array([0, 1], dtype="int64"),
                         mx.nd.array([2, 3], dtype="int64"),
                         mx.nd.array([4], dtype="int64")])


# -- vision datasets --------------------------------------------------------

def _write_cifar(root, rows, hundred):
    rng = np.random.RandomState(3)
    width = 3072 + (2 if hundred else 1)
    names = ["train.bin", "test.bin"] if hundred else \
        ["data_batch_%d.bin" % (i + 1) for i in range(5)] + ["test_batch.bin"]
    for name in names:
        rec = rng.randint(0, 256, (rows, width)).astype(np.uint8)
        rec[:, 0] = rng.randint(0, 20 if hundred else 10, rows)
        if hundred:
            rec[:, 1] = rng.randint(0, 100, rows)
        (root / name).write_bytes(rec.tobytes())


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100", "CIFAR100-fine"])
@pytest.mark.parametrize("train", [True, False])
def test_vision_dataset_reads_files(tmp_path, name, train):
    kwargs = {"train": train}
    if name in ("MNIST", "FashionMNIST"):
        xtr, ytr, xte, yte = synthetic_mnist(12, 5, seed=2)
        write_mnist(str(tmp_path), xtr, ytr, train=True)
        write_mnist(str(tmp_path), xte, yte, train=False)
    else:
        _write_cifar(tmp_path, 6, name.startswith("CIFAR100"))
        if name == "CIFAR100-fine":
            kwargs["fine_label"] = True
    cls = name.split("-")[0]
    mine = getattr(mx.gluon.data.vision, cls)(root=str(tmp_path), **kwargs)
    ref = getattr(jmx.gluon.data.vision, cls)(root=str(tmp_path), **kwargs)
    assert mine._data.context == mx.cpu()
    assert len(mine) == len(ref)
    np.testing.assert_array_equal(mine._data.asnumpy(), ref._data.asnumpy())
    np.testing.assert_array_equal(mine._label, ref._label)
    if cls in ("MNIST", "FashionMNIST"):
        np.testing.assert_array_equal(
            mine._data.asnumpy()[..., 0], xtr if train else xte)
    x, y = mine[3]
    _same(x, ref[3][0])
    assert y == ref[3][1]


@pytest.mark.parametrize("cls", ["MNIST", "CIFAR10", "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_vision_dataset_synthetic_fallback_same_bytes(tmp_path, cls, train):
    mine = getattr(mx.gluon.data.vision, cls)(root=str(tmp_path / "m"),
                                              train=train)
    ref = getattr(jmx.gluon.data.vision, cls)(root=str(tmp_path / "r"),
                                              train=train)
    assert mine._data.dtype == np.uint8
    assert mine._data.context == mx.cpu()
    np.testing.assert_array_equal(mine._data.asnumpy(), ref._data.asnumpy())
    np.testing.assert_array_equal(mine._label, ref._label)


def test_mnist_loader_batches_on_the_host(tmp_path):
    """MNIST behind ToTensor and a DataLoader: batches of (N, 1, 28, 28)
    float32 in [0, 1] and int32 labels, on the host, equal to the
    reference's loader under one seed."""
    xtr, ytr, _, _ = synthetic_mnist(50, 1, seed=4)
    write_mnist(str(tmp_path), xtr, ytr)
    got = []
    for pkg in (mx, jmx):
        ds = pkg.gluon.data.vision.MNIST(root=str(tmp_path)).transform_first(
            pkg.gluon.data.vision.transforms.ToTensor())
        np.random.seed(9)
        got.append(list(pkg.gluon.data.DataLoader(ds, batch_size=16,
                                                  shuffle=True)))
    assert [b[0].shape for b in got[0]] == [(16, 1, 28, 28)] * 3 + \
        [(2, 1, 28, 28)]
    for (x, y), (rx, ry) in zip(*got):
        assert x.context == mx.cpu() and y.context == mx.cpu()
        assert x.dtype == np.float32 and y.dtype == np.int32
        np.testing.assert_array_equal(x.asnumpy(), rx.asnumpy())
        np.testing.assert_array_equal(y.asnumpy(), ry.asnumpy())


def test_hygiene_scan_covers_the_data_slice():
    """tests/test_torch_hygiene.py scans every file of the port; the new
    modules, the worker entry point among them, are in its list."""
    names = {p.relative_to(ROOT).as_posix()
             for p in (ROOT / "mxnet_tpu_torch").rglob("*.py")}
    for module in ("metric.py", "image.py", "callback.py", "gluon/utils.py",
                   "gluon/data/dataloader.py", "gluon/data/dataset.py",
                   "gluon/data/sampler.py", "gluon/data/vision/datasets.py",
                   "gluon/data/vision/transforms.py",
                   "gluon/contrib/data/sampler.py",
                   "gluon/contrib/estimator/estimator.py",
                   "gluon/contrib/estimator/event_handler.py"):
        assert "mxnet_tpu_torch/" + module in names
