"""The port's image iterators (`mx.io.ImageRecordIter`,
`ImageRecordUInt8Iter`, `CSVIter`, `MNISTIter`, `mx.image.ImageIter`) and
record datasets against the JAX package's.

Every case writes its pack or files with numpy from a seed and iterates
both packages over them. Tolerances:

- batches, labels, `pad`, partitions and epoch orders: exact, except
- where an image is resized (ImageRecordIter's shorter side: the port's
  antialiased bilinear against PIL's; ImageIter's augmenters: the port's
  `imresize` against ``jax.image.resize``): uint8 within one level, so a
  float batch within one level times its scale;
- the mean image computed over a pack: exact.
"""
import os
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _make_rec(tmp_path, n=24, size=40, classes=4, with_idx=True, seed=0,
              widths=None, name="data", label_width=1):
    """A .rec(+.idx) pack of seeded uint8 images via the port's
    pack_img (byte-identical to the JAX package's)."""
    rec_path = str(tmp_path / (name + ".rec"))
    idx_path = str(tmp_path / (name + ".idx"))
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, (n, label_width)).astype(np.float32)
    w = recordio.MXIndexedRecordIO(idx_path, rec_path, "w") if with_idx \
        else recordio.MXRecordIO(rec_path, "w")
    for i in range(n):
        wd = size if widths is None else rng.randint(*widths)
        img = rng.randint(0, 255, (size, wd, 3), dtype=np.uint8)
        lab = float(labels[i, 0]) if label_width == 1 else labels[i]
        buf = recordio.pack_img(recordio.IRHeader(0, lab, i, 0), img)
        if with_idx:
            w.write_idx(i, buf)
        else:
            w.write(buf)
    w.close()
    return rec_path, idx_path, labels[:, 0] if label_width == 1 else labels


def _both(name, **kw):
    return getattr(mx.io, name)(**kw), getattr(jmx.io, name)(**kw)


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _assert_epochs(a, b, tol=0.0, rel=0.0):
    """Equal pads and labels; data exactly, within `tol`, or within `rel`
    of the batch's max abs."""
    assert len(a) == len(b)
    for (xa, la, pa), (xb, lb, pb) in zip(a, b):
        assert pa == pb
        assert xa.shape == xb.shape and xa.dtype == xb.dtype
        np.testing.assert_array_equal(la, lb)
        limit = max(tol, rel * float(np.abs(xb).max()))
        if limit:
            assert np.abs(xa.astype(np.float64) - xb).max() <= limit
        else:
            np.testing.assert_array_equal(xa, xb)


# -- ImageRecordIter (tests/test_io.py, as comparisons) ----------------------

def test_image_record_iter(tmp_path):
    rec, idx, labels = _make_rec(tmp_path)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
              batch_size=8, shuffle=False, preprocess_threads=2)
    it, ref = _both("ImageRecordIter", **kw)
    batches, want = _epoch(it), _epoch(ref)
    _assert_epochs(batches, want)
    assert len(batches) == 3
    assert batches[0][0].shape == (8, 3, 32, 32)
    np.testing.assert_array_equal(batches[0][1], labels[:8])
    it.reset()
    _assert_epochs(_epoch(it), batches)
    assert it.provide_data == [mx.io.DataDesc("data", (8, 3, 32, 32))]
    assert it.provide_label[0].shape == ref.provide_label[0].shape


def test_image_record_iter_no_idx_round_batch(tmp_path):
    rec, _, _ = _make_rec(tmp_path, n=10, with_idx=False)
    it, ref = _both("ImageRecordIter", path_imgrec=rec,
                    data_shape=(3, 32, 32), batch_size=8, round_batch=True,
                    preprocess_threads=1)
    batches = _epoch(it)
    _assert_epochs(batches, _epoch(ref))
    assert len(batches) == 2 and batches[1][2] == 6
    # the reference's index path: path_imgrec + ".idx", rebuilt and kept
    # in memory
    assert not os.path.exists(rec + ".idx")


@pytest.mark.parametrize("part_index", [0, 1, 2])
def test_image_record_iter_augment_and_partition(tmp_path, part_index):
    rec, idx, _ = _make_rec(tmp_path, n=20)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 24, 24),
              batch_size=5, shuffle=True, seed=7, rand_crop=True,
              rand_mirror=True, mean_r=123.0, mean_g=117.0, mean_b=104.0,
              std_r=58.0, std_g=57.0, std_b=57.0, part_index=part_index,
              num_parts=3, preprocess_threads=2)
    it, ref = _both("ImageRecordIter", **kw)
    # ceil slicing: 7, 7 and 6 records
    assert it._keys == ref._keys
    assert len(it._keys) == (6 if part_index == 2 else 7)
    for _ in range(3):          # three epochs: each its own order
        a = _epoch(it)
        _assert_epochs(a, _epoch(ref))
        assert len(a) == 2 and abs(a[0][0].mean()) < 2.0
        np.testing.assert_array_equal(it._epoch_order, ref._epoch_order)
        it.reset()
        ref.reset()


def test_image_record_iter_trains_zoo_resnet(tmp_path):
    """The batches that the reference's test trains resnet18_v1 on are the
    JAX package's, and the port's FusedTrainStep learns from them."""
    rec, idx, _ = _make_rec(tmp_path, n=16, size=36, classes=4)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
              batch_size=8, shuffle=True, seed=1, preprocess_threads=2,
              scale=1.0 / 255)
    it, ref = _both("ImageRecordIter", **kw)
    mx.random.seed(11)
    net = mx.gluon.model_zoo.vision.resnet18_v1(classes=4)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.005, "momentum": 0.9})
    fused = mx.gluon.FusedTrainStep(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), trainer)
    losses = []
    for _ in range(6):
        it.reset()
        ref.reset()
        epoch = []
        for batch, want in zip(it, ref):
            np.testing.assert_array_equal(batch.data[0].asnumpy(),
                                          want.data[0].asnumpy())
            np.testing.assert_array_equal(batch.label[0].asnumpy(),
                                          want.label[0].asnumpy())
            epoch.append(float(fused(batch.data[0],
                                     batch.label[0]).asnumpy()))
        losses.append(sum(epoch) / len(epoch))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("resize", [-1, 36, 50])
def test_image_record_iter_resize_within_one_level(tmp_path, resize):
    """Shorter sides 30-40 wide images: a resize (to 36 or 50, or up to
    the crop's 32 where the image is shorter) through the port's
    antialiased bilinear and PIL's, within one uint8 level; a pack that
    needs none is exact."""
    pytest.importorskip("PIL")
    rec, idx, _ = _make_rec(tmp_path, n=12, size=30, widths=(28, 45))
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
              batch_size=4, resize=resize, rand_crop=True, rand_mirror=True,
              shuffle=True, seed=3, preprocess_threads=3)
    it, ref = _both("ImageRecordIter", **kw)
    _assert_epochs(_epoch(it), _epoch(ref), tol=1.0)
    it, ref = _both("ImageRecordUInt8Iter", **kw)
    _assert_epochs(_epoch(it), _epoch(ref), tol=1.0)


def test_image_record_iter_exact_at_target_short_side(tmp_path):
    rec, idx, _ = _make_rec(tmp_path, n=9, size=32, widths=(32, 48))
    it, ref = _both("ImageRecordIter", path_imgrec=rec, path_imgidx=idx,
                    data_shape=(3, 32, 32), batch_size=4, resize=32,
                    rand_crop=True, shuffle=True, seed=2,
                    preprocess_threads=2)
    _assert_epochs(_epoch(it), _epoch(ref))


def test_image_record_iter_label_width(tmp_path):
    rec, idx, labels = _make_rec(tmp_path, n=10, label_width=3)
    it, ref = _both("ImageRecordIter", path_imgrec=rec, path_imgidx=idx,
                    data_shape=(3, 32, 32), batch_size=4, label_width=3,
                    preprocess_threads=2)
    batches = _epoch(it)
    _assert_epochs(batches, _epoch(ref))
    np.testing.assert_array_equal(batches[0][1], labels[:4])
    assert it.provide_label[0].shape == (4, 3)


def test_image_record_iter_exhaustion_no_hang(tmp_path):
    """Past the epoch without reset(): StopIteration at once."""
    rec, idx, _ = _make_rec(tmp_path, n=8)
    it = mx.io.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                               data_shape=(3, 32, 32), batch_size=8,
                               preprocess_threads=1)
    assert len(list(it)) == 1
    assert len(list(it)) == 0
    it.reset()
    assert len(list(it)) == 1


def test_image_record_iter_dropped_mid_epoch_stops(tmp_path):
    """An iterator dropped with batches still to make is collected, and
    its prefetch thread ends."""
    import gc
    import time
    import weakref
    rec, idx, _ = _make_rec(tmp_path, n=40)
    it = mx.io.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                               data_shape=(3, 32, 32), batch_size=4,
                               prefetch_buffer=1, preprocess_threads=1)
    it.next()
    thread = it._prefetch._thread
    ref = weakref.ref(it)
    del it
    deadline = time.time() + 10
    while ref() is not None and time.time() < deadline:
        gc.collect()        # the thread may hold it through one batch
        time.sleep(0.05)
    assert ref() is None
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_image_record_iter_seeded_augment_reproducible(tmp_path):
    rec, idx, _ = _make_rec(tmp_path, n=12)

    def epochs(pkg, threads):
        it = pkg.io.ImageRecordIter(
            path_imgrec=rec, path_imgidx=idx, data_shape=(3, 24, 24),
            batch_size=4, shuffle=True, seed=5, rand_crop=True,
            rand_mirror=True, preprocess_threads=threads)
        out = _epoch(it)
        it.reset()
        return out + _epoch(it)
    a = epochs(mx, 3)
    assert len(a) == 6
    _assert_epochs(a, epochs(mx, 1))
    _assert_epochs(a, epochs(jmx, 3))


def test_image_record_iter_pad_exceeds_epoch(tmp_path):
    rec, idx, labels = _make_rec(tmp_path, n=3)
    for round_batch in (True, False):
        it, ref = _both("ImageRecordIter", path_imgrec=rec,
                        path_imgidx=idx, data_shape=(3, 32, 32),
                        batch_size=8, round_batch=round_batch,
                        preprocess_threads=1)
        batches = _epoch(it)
        _assert_epochs(batches, _epoch(ref))
        assert batches[0][2] == 5
        exp = np.tile(labels, 3)[:8] if round_batch else \
            np.concatenate([labels, np.repeat(labels[-1:], 5)])
        np.testing.assert_array_equal(batches[0][1], exp)


def test_image_record_iter_mean_img(tmp_path):
    """A missing mean_img file is computed over the pack and written;
    each package reads the file the other wrote."""
    rec, idx, _ = _make_rec(tmp_path, n=6, size=34)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
              batch_size=6, preprocess_threads=1)
    mine_path, ref_path = str(tmp_path / "mine.bin"), str(tmp_path /
                                                          "ref.bin")
    it = mx.io.ImageRecordIter(mean_img=mine_path, **kw)
    ref = jmx.io.ImageRecordIter(mean_img=ref_path, **kw)
    np.testing.assert_array_equal(it._mean_arr, ref._mean_arr)
    with open(mine_path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
    b = _epoch(it)
    _assert_epochs(b, _epoch(ref))
    assert abs(b[0][0].mean()) < 1.0
    it2 = mx.io.ImageRecordIter(mean_img=ref_path, **kw)
    ref2 = jmx.io.ImageRecordIter(mean_img=mine_path, **kw)
    _assert_epochs(_epoch(it2), b)
    _assert_epochs(_epoch(ref2), b)


def test_image_record_uint8_iter(tmp_path):
    rec, idx, _ = _make_rec(tmp_path)
    it, ref = _both("ImageRecordUInt8Iter", path_imgrec=rec,
                    path_imgidx=idx, data_shape=(3, 32, 32), batch_size=8,
                    mean_r=10.0, scale=0.5)
    batches = _epoch(it)
    _assert_epochs(batches, _epoch(ref))
    assert batches[0][0].dtype == np.uint8 and batches[0][0].max() > 1
    assert batches[0][0].shape == (8, 3, 32, 32)


def test_image_record_iter_one_channel(tmp_path):
    rec, idx, _ = _make_rec(tmp_path, n=6)
    it, ref = _both("ImageRecordIter", path_imgrec=rec, path_imgidx=idx,
                    data_shape=(1, 32, 32), batch_size=3, mean_r=1.0,
                    std_r=2.0, preprocess_threads=2)
    a = _epoch(it)
    _assert_epochs(a, _epoch(ref))
    assert a[0][0].shape == (3, 1, 32, 32)


# -- CSVIter and MNISTIter ---------------------------------------------------

def test_csv_iter(tmp_path):
    data_csv, label_csv = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    rng = np.random.RandomState(3)
    d = rng.rand(11, 6).astype(np.float32)
    lab = rng.randint(0, 3, (11, 1)).astype(np.float32)
    np.savetxt(data_csv, d, delimiter=",")
    np.savetxt(label_csv, lab, delimiter=",")
    it, ref = _both("CSVIter", data_csv=data_csv, data_shape=(2, 3),
                    label_csv=label_csv, batch_size=4)
    batches = _epoch(it)
    _assert_epochs(batches, _epoch(ref))
    assert len(batches) == 3 and batches[2][2] == 1
    np.testing.assert_allclose(batches[0][0], d[:4].reshape(4, 2, 3),
                               rtol=1e-5)
    np.testing.assert_array_equal(batches[0][1], lab[:4, 0])
    it.reset()
    ref.reset()
    _assert_epochs(_epoch(it), _epoch(ref))


def test_csv_iter_no_round_batch_keeps_tail(tmp_path):
    data_csv = str(tmp_path / "d2.csv")
    np.savetxt(data_csv, np.arange(10, dtype=np.float32).reshape(10, 1),
               delimiter=",")
    it, ref = _both("CSVIter", data_csv=data_csv, data_shape=(1,),
                    batch_size=4, round_batch=False)
    batches = _epoch(it)
    _assert_epochs(batches, _epoch(ref))
    assert len(batches) == 3 and batches[2][2] == 2
    np.testing.assert_array_equal(batches[2][0][:2, 0], [8, 9])


def test_csv_iter_wrapped_lines_and_label_shape(tmp_path):
    path = str(tmp_path / "wrap.csv")
    vals = np.arange(24, dtype=np.float32)
    with open(path, "w") as f:
        for i in range(0, 24, 4):
            f.write(",".join(str(v) for v in vals[i:i + 4]) + "\n")
    it, ref = _both("CSVIter", data_csv=path, data_shape=(6,), batch_size=1)
    rows = _epoch(it)
    _assert_epochs(rows, _epoch(ref))
    np.testing.assert_array_equal(np.concatenate([r[0][0] for r in rows]),
                                  vals)
    path2 = str(tmp_path / "long.csv")
    with open(path2, "w") as f:
        f.write(",".join(str(v) for v in vals) + "\n")
    it, ref = _both("CSVIter", data_csv=path2, data_shape=(6,),
                    label_csv=path2, label_shape=(2, 3), batch_size=3)
    b = _epoch(it)
    _assert_epochs(b, _epoch(ref))
    assert b[0][0].shape == (3, 6) and b[0][1].shape == (3, 2, 3)


def _mnist_files(tmp_path, n=30, seed=5):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 255, (n, 28, 28), dtype=np.uint8)
    labs = rng.randint(0, 10, n).astype(np.uint8)
    img_path = str(tmp_path / "images-idx3-ubyte")
    lab_path = str(tmp_path / "labels-idx1-ubyte")
    with open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(imgs.tobytes())
    with open(lab_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labs.tobytes())
    return img_path, lab_path, imgs, labs


@pytest.mark.parametrize("kw", [
    dict(shuffle=False), dict(shuffle=True, seed=2, flat=True),
    dict(shuffle=True, seed=3, part_index=1, num_parts=2)])
def test_mnist_iter(tmp_path, kw):
    img_path, lab_path, imgs, labs = _mnist_files(tmp_path)
    it, ref = _both("MNISTIter", image=img_path, label=lab_path,
                    batch_size=8, silent=True, **kw)
    for _ in range(2):
        batches = _epoch(it)
        _assert_epochs(batches, _epoch(ref))
        it.reset()
        ref.reset()
    if not kw.get("shuffle"):
        assert len(batches) == 3
        assert batches[0][0].shape == (8, 1, 28, 28)
        np.testing.assert_allclose(batches[0][0][:, 0],
                                   imgs[:8].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(batches[0][1], labs[:8])
    if kw.get("flat"):
        assert batches[0][0].shape == (8, 784)


# -- ImageIter ---------------------------------------------------------------

def _png_folder(tmp_path, n=7, size=20, seed=0):
    from PIL import Image
    rng = np.random.RandomState(seed)
    entries = []
    for i in range(n):
        arr = rng.randint(0, 255, (size, size + i, 3), dtype=np.uint8)
        fname = "img%d.png" % i
        Image.fromarray(arr).save(str(tmp_path / fname))
        entries.append((float(i % 3), fname))
    return entries


def _image_iters(**kw):
    """Both packages' ImageIter, each made after the same seeds (a
    shuffling ImageIter shuffles its keys when it is made)."""
    out = []
    for pkg in (mx, jmx):
        random.seed(99)
        np.random.seed(99)
        out.append(pkg.image.ImageIter(**kw))
    return out


def _seeded_epochs(it, ref, n=2, seed=0):
    a, b = [], []
    for e in range(n):
        for pkg_it, out in ((it, a), (ref, b)):
            random.seed(seed + e)
            np.random.seed(seed + e)
            pkg_it.reset()
            out.extend(_epoch(pkg_it))
    return a, b


AUGS = [dict(), dict(resize=24, rand_crop=True, rand_mirror=True),
        dict(rand_crop=True, rand_resize=True, rand_mirror=True,
             mean=True, std=True),
        dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1,
             pca_noise=0.1, rand_gray=0.2)]


def _tol(kw):
    """(tol, rel): uint8 within one level ahead of the cast (a resize or
    a random sized crop), scaled by 1 / std; float jitters within 1e-5 of
    the batch's max abs; else exact."""
    if kw.get("resize") or kw.get("rand_resize"):
        return (1.0 / 57.12 if kw.get("std") else 1.0), 0.0
    return 0.0, (1e-5 if kw.get("brightness") else 0.0)


@pytest.mark.parametrize("kw", AUGS)
def test_image_iter_rec_under_create_augmenter(tmp_path, kw):
    rec, _, _ = _make_rec(tmp_path, n=10, size=30, widths=(30, 40))
    it, ref = _image_iters(batch_size=4, data_shape=(3, 16, 16),
                           path_imgrec=rec, shuffle=True, **kw)
    a, b = _seeded_epochs(it, ref)
    _assert_epochs(a, b, *_tol(kw))
    assert [x[2] for x in a] == [0, 0, 2] * 2


def test_image_iter_rec_without_idx_reads_in_file_order(tmp_path):
    rec, _, labels = _make_rec(tmp_path, n=6, with_idx=False)
    it, ref = _image_iters(batch_size=4, data_shape=(3, 32, 32),
                           path_imgrec=rec)
    assert it.seq is None and ref.seq is None
    a, b = _seeded_epochs(it, ref)
    _assert_epochs(a, b)
    np.testing.assert_array_equal(a[0][1], labels[:4])


def test_image_iter_index_path_is_splitext(tmp_path):
    """ImageIter reads splitext(path_imgrec)[0] + ".idx" (ImageRecordIter
    path_imgrec + ".idx"): with the index in the shuffled order of
    records, the keys come in that order."""
    rec, idx, labels = _make_rec(tmp_path, n=8)
    with open(idx) as f:
        lines = f.readlines()
    with open(idx, "w") as f:
        f.writelines(lines[::-1])
    it, ref = _image_iters(batch_size=8, data_shape=(3, 32, 32),
                           path_imgrec=rec)
    assert it.seq == ref.seq == list(range(7, -1, -1))
    a, b = _seeded_epochs(it, ref, n=1)
    _assert_epochs(a, b)
    np.testing.assert_array_equal(a[0][1], labels[::-1])


@pytest.mark.parametrize("kw", AUGS[:2])
def test_image_iter_lst_and_imglist(tmp_path, kw):
    pytest.importorskip("PIL")
    entries = _png_folder(tmp_path)
    lst = str(tmp_path / "x.lst")
    with open(lst, "w") as f:
        for i, (lab, fname) in enumerate(entries):
            f.write("%d\t%f\t%s\n" % (i, lab, fname))
    common = dict(batch_size=3, data_shape=(3, 16, 16),
                  path_root=str(tmp_path), shuffle=True, **kw)
    for src in (dict(path_imglist=lst), dict(imglist=entries)):
        it, ref = _image_iters(**src, **common)
        a, b = _seeded_epochs(it, ref, seed=4)
        _assert_epochs(a, b, *_tol(kw))
        assert [x[2] for x in a] == [0, 0, 2] * 2


@pytest.mark.parametrize("part_index", [0, 1, 2])
def test_image_iter_partitions_floor(tmp_path, part_index):
    rec, _, _ = _make_rec(tmp_path, n=11)
    it, ref = _image_iters(batch_size=3, data_shape=(3, 32, 32),
                           path_imgrec=rec, part_index=part_index,
                           num_parts=3)
    assert it.seq == ref.seq == list(range(3 * part_index,
                                           3 * part_index + 3))
    _assert_epochs(*_seeded_epochs(it, ref, n=1))


def test_image_iter_label_width_and_dtype(tmp_path):
    rec, _, labels = _make_rec(tmp_path, n=5, label_width=2)
    it, ref = _image_iters(batch_size=4, data_shape=(3, 32, 32),
                           path_imgrec=rec, label_width=2,
                           dtype="float16")
    a, b = _seeded_epochs(it, ref, n=1)
    _assert_epochs(a, b)
    assert a[0][0].dtype == np.float16
    np.testing.assert_array_equal(a[0][1], labels[:4])


def test_image_iter_decodes_on_cpu_whatever_the_context(tmp_path,
                                                        monkeypatch):
    """The kept deviation: each image is decoded and augmented on cpu(),
    and only the batch goes to the current context. Under a card context
    the samples still come out on the host, and the augmenters never see
    another context."""
    rec, _, _ = _make_rec(tmp_path, n=5)
    it = mx.image.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                            path_imgrec=rec, rand_mirror=True)
    seen = []
    aug = it.auglist[0]

    def spy(src):
        seen.append(src.context)
        return aug(src)
    it.auglist[0] = spy
    calls = []
    real = mx.nd.array

    def array(source, ctx=None, dtype=None):
        calls.append(ctx)
        return real(source, ctx=ctx, dtype=dtype)
    with mx.gpu(0):
        label, img = it.next_sample()
        assert img.context == mx.cpu()
        monkeypatch.setattr(mx.nd, "array", array)
        try:
            it.next()
        except mx.MXNetError:   # no card here: the batch's placement
            pass
    assert set(seen) == {mx.cpu()}
    # four samples decoded onto cpu(), then the batch on the current
    # context
    assert calls[:4] == [mx.cpu()] * 4 and calls[4] is None


# -- the record datasets -----------------------------------------------------

def test_record_file_dataset(tmp_path):
    rec, _, _ = _make_rec(tmp_path, n=9)
    ds = mx.gluon.data.RecordFileDataset(rec)
    ref = jmx.gluon.data.RecordFileDataset(rec)
    assert len(ds) == len(ref) == 9
    for i in (0, 4, 8):
        assert ds[i] == ref[i]


def test_image_record_dataset(tmp_path):
    rec, _, labels = _make_rec(tmp_path, n=7)
    ds = mx.gluon.data.vision.ImageRecordDataset(rec)
    ref = jmx.gluon.data.vision.ImageRecordDataset(rec)
    assert len(ds) == len(ref) == 7
    for i in range(7):
        (img, lab), (rimg, rlab) = ds[i], ref[i]
        assert img.context == mx.cpu() and img.dtype == np.uint8
        np.testing.assert_array_equal(img.asnumpy(), rimg.asnumpy())
        assert float(lab) == float(rlab) == float(labels[i])
    t = mx.gluon.data.vision.ImageRecordDataset(
        rec, transform=lambda x, y: (x.astype("float32") / 255, y + 1))
    np.testing.assert_allclose(t[2][0].asnumpy(), ds[2][0].asnumpy() / 255)
    assert float(t[2][1]) == float(labels[2]) + 1


def test_image_folder_dataset_png_and_npy(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    rng = np.random.RandomState(8)
    for c, ext in (("cat", ".png"), ("dog", ".npy"), ("emu", ".png")):
        os.makedirs(tmp_path / c)
        for i in range(2):
            arr = rng.randint(0, 255, (6, 7, 3), dtype=np.uint8)
            path = str(tmp_path / c / ("i%d%s" % (i, ext)))
            if ext == ".npy":
                np.save(path, arr)
            else:
                Image.fromarray(arr).save(path)
    (tmp_path / "cat" / "notes.txt").write_text("skipped")
    (tmp_path / "readme").write_text("not a folder")
    ds = mx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    ref = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    assert ds.synsets == ref.synsets == ["cat", "dog", "emu"]
    assert ds.items == ref.items and len(ds) == 6
    for i in range(6):
        (img, lab), (rimg, rlab) = ds[i], ref[i]
        assert lab == rlab and img.context == mx.cpu()
        assert img.dtype == rimg.dtype
        np.testing.assert_array_equal(img.asnumpy(), rimg.asnumpy())


class _ToFloat:
    def __call__(self, x, y):
        return x.astype("float32") / 255, y


class _AsArray:
    def __call__(self, record):
        return np.frombuffer(record, np.uint8)


@pytest.mark.parametrize("workers", [0, 2])
def test_record_datasets_under_the_dataloader(tmp_path, workers):
    """Two spawned workers reopen the pack and give the batches that the
    main process gives."""
    rec, _, labels = _make_rec(tmp_path, n=10, size=8)
    ds = mx.gluon.data.vision.ImageRecordDataset(rec, transform=_ToFloat())
    loader = mx.gluon.data.DataLoader(ds, batch_size=4, shuffle=False,
                                      num_workers=workers)
    got = [(x.asnumpy(), y.asnumpy()) for x, y in loader]
    want = [(np.stack([ds[i][0].asnumpy() for i in range(s, min(s + 4,
                                                                10))]),
             labels[s:s + 4]) for s in range(0, 10, 4)]
    assert len(got) == 3
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    raw = mx.gluon.data.RecordFileDataset(rec)
    loader = mx.gluon.data.DataLoader(raw.transform(_AsArray()),
                                      batch_size=5, num_workers=workers)
    got = np.concatenate([b.asnumpy() for b in loader])
    want = np.stack([np.frombuffer(raw[i], np.uint8) for i in range(10)])
    np.testing.assert_array_equal(got, want)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_image_iters_into_the_card_equal_the_cpu(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec, idx, _ = _make_rec(tmp_path, n=10, size=36)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
              batch_size=4, shuffle=True, seed=1, rand_crop=True,
              rand_mirror=True, scale=1.0 / 255, preprocess_threads=2)
    cpu = _epoch(mx.io.ImageRecordIter(**kw))
    with mx.gpu(0):
        it = mx.io.ImageRecordIter(**kw)
        card = [(b.data[0], b.label[0], b.pad) for b in it]
    assert all(x.context == mx.gpu(0) for x, _, _ in card)
    _assert_epochs([(x.asnumpy(), y.asnumpy(), p) for x, y, p in card], cpu)
    # ImageIter/ImageDetIter: the same values whether augmented on the
    # host (the port's route) or on the card
    det = [(np.array([2, 5, 1, .1, .2, .6, .7], np.float32), "img%d.png"
            % i) for i in range(3)]
    pytest.importorskip("PIL")
    entries = _png_folder(tmp_path, n=3, size=36)
    augs = dict(rand_mirror=True, rand_crop=0.5, rand_pad=0.5, mean=True,
                std=True, brightness=0.2)
    outs = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        random.seed(0)
        np.random.seed(0)
        with ctx:
            it = mx.image.ImageDetIter(batch_size=3, data_shape=(3, 32, 32),
                                       imglist=det, path_root=str(tmp_path),
                                       **augs)
            b = it.next()
        outs.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        assert b.data[0].context == ctx
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0, atol=0)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    # augmenting each image on the card gives the host route's values
    random.seed(1)
    np.random.seed(1)
    it = mx.image.ImageIter(batch_size=3, data_shape=(3, 32, 32),
                            imglist=[(e[0], e[1]) for e in entries],
                            path_root=str(tmp_path), rand_crop=True,
                            rand_mirror=True, brightness=0.2, mean=True)
    host = it.next().data[0].asnumpy()
    random.seed(1)
    np.random.seed(1)
    it.reset()
    on_card = []
    for _ in range(3):
        label, img = it.next_sample()
        img = img.as_in_context(mx.gpu(0))
        on_card.append(it.augmentation_transform(img).asnumpy())
    np.testing.assert_allclose(np.stack(on_card).transpose(0, 3, 1, 2),
                               host, rtol=1e-6, atol=1e-4)
