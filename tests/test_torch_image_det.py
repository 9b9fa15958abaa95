"""The port's detection iterator and augmenters (`mx.image.ImageDetIter`,
`CreateDetAugmenter`, the `Det*Aug` family, `mx.io.ImageDetRecordIter`)
against the JAX package's.

Both packages get the same seeded images and labels and, before each
call, the same `random.seed` and `np.random.seed`: the augmenters draw
from those in the same order. Labels and boxes are exact where no resize
is drawn; images within one uint8 level where one is (the port's
`imresize` against ``jax.image.resize``), scaled by 1 / std where the
chain normalizes; exact otherwise.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _make_dataset(tmp_path, n=6, size=32):
    """PNG files + packed det labels [A=2, B=5, id,x1,y1,x2,y2]."""
    from PIL import Image
    rng = np.random.RandomState(0)
    entries = []
    for i in range(n):
        arr = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        fname = "img%d.png" % i
        Image.fromarray(arr).save(str(tmp_path / fname))
        label = [2, 5]
        for j in range(1 + i % 2):
            label += [float(j), 0.2, 0.2, 0.7, 0.7]
        entries.append((np.array(label, np.float32), fname))
    return entries


def _det_pack(tmp_path, n=7, seed=1, header=2):
    """A .rec pack of seeded images (sizes 30-45) with 1 to 4 random
    boxes each, labels [A, 6, id, x1, y1, x2, y2, difficult, ...] with an
    A-wide header."""
    rng = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 255, (rng.randint(30, 46), rng.randint(30, 46),
                                   3), dtype=np.uint8)
        objs = []
        for _ in range(rng.randint(1, 5)):
            x1, y1 = rng.uniform(0, 0.6, 2)
            x2, y2 = x1 + rng.uniform(0.1, 0.4), y1 + rng.uniform(0.1, 0.4)
            objs += [rng.randint(0, 5), x1, y1, x2, y2, rng.randint(2)]
        label = np.array([header, 6] + [9.0] * (header - 2) + objs,
                         np.float32)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, label, i, 0),
                                         img))
    w.close()
    return rec


def _batches(it, n):
    out = []
    for _ in range(n):
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _hold(a, b, tol):
    assert len(a) == len(b)
    for (xa, la, pa), (xb, lb, pb) in zip(a, b):
        assert pa == pb and xa.shape == xb.shape and la.shape == lb.shape
        np.testing.assert_array_equal(la, lb)
        if tol:
            assert np.abs(xa - xb).max() <= tol
        else:
            np.testing.assert_array_equal(xa, xb)


# -- tests/test_image_det.py, as comparisons --------------------------------

def test_image_det_iter(tmp_path):
    pytest.importorskip("PIL")
    entries = _make_dataset(tmp_path)
    its = [pkg.image.ImageDetIter(batch_size=4, data_shape=(3, 16, 16),
                                  imglist=entries, path_root=str(tmp_path))
           for pkg in (mx, jmx)]
    assert its[0].max_objects == its[1].max_objects == 2
    assert its[0].obj_width == its[1].obj_width == 5
    assert tuple(its[0].provide_label[0].shape) == (4, 2, 5)
    a, b = (_batches(it, 3) for it in its)
    _hold(a, b, tol=1.0)        # ForceResizeAug 32 -> 16
    lab = a[0][1]
    assert lab[0, 0, 0] == 0.0 and (lab[0, 1] == -1.0).all()
    np.testing.assert_allclose(lab[0, 0, 1:], [0.2, 0.2, 0.7, 0.7],
                               atol=1e-6)
    assert a[1][2] == 2


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_det_horizontal_flip_flips_boxes(p):
    src = np.random.RandomState(2).rand(8, 8, 3).astype(np.float32)
    label = np.array([[0, 0.1, 0.2, 0.4, 0.6],
                      [-1, -1, -1, -1, -1]], np.float32)
    outs = []
    for pkg in (mx, jmx):
        _seed(3)
        outs.append([pkg.image.DetHorizontalFlipAug(p)(
            pkg.nd.array(src), label.copy()) for _ in range(4)])
    for (ia, la), (ib, lb) in zip(*outs):
        assert ia.context == mx.cpu()
        np.testing.assert_array_equal(ia.asnumpy(), ib.asnumpy())
        np.testing.assert_array_equal(la, lb)
    if p == 1.0:
        np.testing.assert_allclose(outs[0][0][1][0], [0, 0.6, 0.2, 0.9, 0.6],
                                   atol=1e-6)
        assert (outs[0][0][1][1] == -1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_det_random_pad_keeps_boxes_inside(seed):
    src = np.full((8, 8, 3), 255.0, np.float32)
    label = np.array([[1, 0.0, 0.0, 1.0, 1.0], [-1] * 5], np.float32)
    outs = []
    for pkg in (mx, jmx):
        _seed(seed)
        aug = pkg.image.DetRandomPadAug(area_range=(1.5, 2.5),
                                        aspect_ratio_range=(0.8, 1.25))
        outs.append(aug(pkg.nd.array(src), label.copy()))
    (ia, la), (ib, lb) = outs
    np.testing.assert_array_equal(ia.asnumpy(), ib.asnumpy())
    np.testing.assert_array_equal(la, lb)
    w = la[0, 3] - la[0, 1]
    assert 0.5 < w < 1.0 and (la[1] == -1).all()
    assert ia.shape[0] >= 8 and ia.shape[1] >= 8


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_det_random_crop_updates_labels(seed):
    src = np.random.RandomState(seed).rand(32, 32, 3).astype(np.float32)
    label = np.array([[2, 0.25, 0.25, 0.75, 0.75],
                      [1, 0.0, 0.6, 0.3, 0.95],
                      [-1, -1, -1, -1, -1]], np.float32)
    outs = []
    for pkg in (mx, jmx):
        _seed(seed)
        aug = pkg.image.DetRandomCropAug(min_object_covered=0.5,
                                         area_range=(0.5, 0.9),
                                         aspect_ratio_range=(0.8, 1.25))
        outs.append(aug(pkg.nd.array(src), label.copy()))
    (ia, la), (ib, lb) = outs
    np.testing.assert_array_equal(ia.asnumpy(), ib.asnumpy())
    np.testing.assert_array_equal(la, lb)
    kept = la[la[:, 0] >= 0]
    assert len(kept) >= 1
    assert (kept[:, 1:] >= -1e-6).all() and (kept[:, 1:] <= 1 + 1e-6).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_create_det_augmenter_chain(seed):
    kw = dict(rand_mirror=True, rand_crop=0.5, rand_pad=0.5, mean=True,
              std=True)
    chains = [pkg.image.CreateDetAugmenter((3, 16, 16), **kw)
              for pkg in (mx, jmx)]
    assert [type(a).__name__ for a in chains[0]] == \
        [type(a).__name__ for a in chains[1]]
    img = np.random.RandomState(seed).randint(0, 255, (24, 24, 3)).astype(
        np.uint8)
    label = np.array([[0, 0.1, 0.1, 0.8, 0.8], [3, 0.5, 0.4, 0.9, 0.7]],
                     np.float32)
    outs = []
    for pkg, augs in zip((mx, jmx), chains):
        _seed(seed)
        out, lab = pkg.nd.array(img, dtype="uint8"), label
        for a in augs:
            out, lab = a(out, lab)
        outs.append((out.asnumpy(), lab))
    (ia, la), (ib, lb) = outs
    assert ia.shape == (16, 16, 3) and la.shape == label.shape
    np.testing.assert_array_equal(la, lb)
    # the forced resize to 16x16, within one level, over std
    assert np.abs(ia - ib).max() <= 1.0 / 57.12 + 1e-5


# -- ImageDetIter over a pack, and ImageDetRecordIter -----------------------

@pytest.mark.parametrize("kw,tol", [
    (dict(), 1.0),
    (dict(rand_mirror=True, rand_crop=0.5, rand_pad=0.5, mean=True,
          std=True, brightness=0.1, contrast=0.1, saturation=0.1), 0.05),
])
def test_image_det_iter_rec(tmp_path, kw, tol):
    rec = _det_pack(tmp_path, header=4)
    its = []
    for pkg in (mx, jmx):
        _seed(7)
        its.append(pkg.image.ImageDetIter(batch_size=3,
                                          data_shape=(3, 24, 24),
                                          path_imgrec=rec, shuffle=True,
                                          **kw))
    assert its[0].max_objects == its[1].max_objects
    assert its[0].obj_width == its[1].obj_width == 6
    outs = []
    for it in its:
        _seed(8)
        outs.append(_batches(it, 5))
    _hold(*outs, tol=tol)


def test_image_det_iter_no_resize_is_exact(tmp_path):
    """Images already at the data shape and no random augmentation: the
    batches and labels are the images and boxes, bit for bit."""
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (5, 20, 20, 3), dtype=np.uint8)
    rec, idx = str(tmp_path / "e.rec"), str(tmp_path / "e.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    boxes = []
    for i, img in enumerate(imgs):
        obj = np.array([[i % 3, .1, .2, .5, .9]] * (1 + i % 3), np.float32)
        boxes.append(obj)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(
            0, np.concatenate([[2, 5], obj.ravel()]).astype(np.float32), i,
            0), img))
    w.close()
    its = [pkg.image.ImageDetIter(batch_size=2, data_shape=(3, 20, 20),
                                  path_imgrec=rec) for pkg in (mx, jmx)]
    a, b = (_batches(it, 3) for it in its)
    _hold(a, b, tol=0)
    for k, (x, lab, pad) in enumerate(a):
        for j in range(2 - pad):
            i = 2 * k + j
            np.testing.assert_array_equal(x[j].transpose(1, 2, 0), imgs[i])
            np.testing.assert_array_equal(lab[j, :len(boxes[i])], boxes[i])
            assert (lab[j, len(boxes[i]):] == -1).all()


def test_image_det_record_iter(tmp_path):
    rec = _det_pack(tmp_path, seed=3)
    kw = dict(path_imgrec=rec, batch_size=4, data_shape=(3, 24, 24),
              mean_r=120.0, mean_g=110.0, mean_b=100.0, std_r=60.0,
              std_g=60.0, std_b=60.0)
    its = [pkg.io.ImageDetRecordIter(**kw) for pkg in (mx, jmx)]
    a, b = (_batches(it, 2) for it in its)
    _hold(a, b, tol=1.0 / 60 + 1e-5)
    for pkg in (mx, jmx):
        with pytest.raises(pkg.MXNetError, match="unsupported"):
            pkg.io.ImageDetRecordIter(path_imgrec=rec, batch_size=2,
                                      data_shape=(3, 8, 8), rand_shrink=1)


def test_det_label_validation():
    for pkg in (mx, jmx):
        with pytest.raises(ValueError):
            pkg.image.ImageDetIter._parse_label([2.0])
        with pytest.raises(ValueError):
            pkg.image.ImageDetIter._parse_label([2.0, 4.0, 1, 2, 3, 4])
    np.testing.assert_array_equal(
        mx.image.ImageDetIter._parse_label([3, 5, 7, 1, .1, .1, .2, .2]),
        jmx.image.ImageDetIter._parse_label([3, 5, 7, 1, .1, .1, .2, .2]))
