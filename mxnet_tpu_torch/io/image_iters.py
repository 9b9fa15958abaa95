"""The reference's C++ data iterators (the port of
`mxnet_tpu.io.image_iters`): `ImageRecordIter`, `ImageRecordUInt8Iter`,
`CSVIter`, `MNISTIter` and `ImageDetRecordIter`.

reference: src/io/iter_image_recordio_2.cc (ImageRecordIOParser2),
src/io/iter_csv.cc, src/io/iter_mnist.cc, src/io/iter_prefetcher.h and
src/io/image_aug_default.cc.

`ImageRecordIter` decodes and augments on `preprocess_threads` host
threads into a uint8 HWC batch, converts it to normalized float32 CHW in
one pass of the native helper (`native.batch_to_chw_norm`), and a
background thread keeps `prefetch_buffer` batches ready. All of that is
numpy: only `next()`, on the caller's thread, makes the batch's arrays on
the current context. Each record's crop and mirror come from a generator
seeded by (seed, epoch, position) and each epoch's order from one seeded
by (seed, epoch), with the JAX package's formulas, so one seed gives both
packages the same batches whatever the threads' scheduling. A record
whose shorter side must change is resized with
``torch.nn.functional.interpolate`` (bilinear, antialiased) on the host
tensor, the filter of PIL's bilinear resize that the JAX package uses,
within one uint8 level of it; the port needs no PIL for `.npy` packs.
"""
from __future__ import annotations

import os
import struct
import queue as _queue
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from .. import recordio as _recordio
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray, array
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter", "CSVIter", "MNISTIter",
           "ImageDetRecordIter"]


def _resize_short(img, size):
    """A HWC uint8 numpy image resized so that its shorter side is `size`
    (reference: image_aug_default.cc's resize): bilinear with
    antialiasing on the host tensor, rounded back to uint8."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    if (nh, nw) == (h, w):
        return img
    t = torch.from_numpy(_np.ascontiguousarray(img)).permute(2, 0, 1)
    out = torch.nn.functional.interpolate(
        t[None].float(), size=(nh, nw), mode="bilinear", align_corners=False,
        antialias=True)[0]
    return out.round_().clamp_(0, 255).to(torch.uint8).permute(
        1, 2, 0).contiguous().numpy()


def _on_current(a):
    """A batch array that the producer made and hands over, as an NDArray
    of its own dtype on the current context: copied once, to the device
    (`nd.array` would first copy it on the host)."""
    ctx = current_context()
    return NDArray(torch.from_numpy(a).to(ctx.torch_device), ctx=ctx)


class _EndOfEpoch:
    pass


class _BackgroundPrefetcher:
    """dmlc::ThreadedIter analog: a producer thread keeps `depth` ready
    batches; end-of-epoch and exceptions are forwarded through the queue.

    Every start() creates a fresh (event, queue) pair captured by the
    worker, so a stop()/start() cycle can never revive an old producer: the
    old thread only checks its own event and puts to its own queue (with a
    timeout, so it cannot block forever on an abandoned full queue). The
    thread holds its iterator only while it produces a batch (a weak
    reference otherwise), so an iterator that is dropped mid-epoch is
    collected, and its `__del__` stops the thread."""

    def __init__(self, produce, depth):
        self._produce = weakref.WeakMethod(produce)
        self._depth = max(1, int(depth))
        self._queue = None
        self._thread = None
        self._stop = None

    def start(self):
        stop = threading.Event()
        q = _queue.Queue(maxsize=self._depth)
        self._stop, self._queue = stop, q
        produce = self._produce

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except _queue.Full:
                    continue

        def worker():
            try:
                while not stop.is_set():
                    fn = produce()
                    if fn is None:      # the iterator was collected
                        return
                    item = fn()
                    del fn
                    put(_EndOfEpoch() if item is None else item)
                    if item is None:
                        return
            except Exception as e:  # surfaces at the consumer's next();
                # keep trying (stop-checked): dropping it would leave the
                # consumer blocked forever on a dead producer
                put(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self):
        if self._stop is not None:
            self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
        if self._thread is not None:
            if self._thread is not threading.current_thread():
                self._thread.join(timeout=10)
            self._thread = None

    def get(self):
        """Next item; _EndOfEpoch when the epoch is exhausted."""
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item


class ImageRecordIter(DataIter):
    """`mx.io.ImageRecordIter` — batched, augmented images out of a RecordIO
    pack. reference: src/io/iter_image_recordio_2.cc exposed through
    MXDataIterCreateIter; same parameter surface for the common args.

    path_imgrec/.idx files are the ones `tools.im2rec` or
    `recordio.pack_img` write (payloads may be JPEG/PNG or raw .npy, see
    image.imdecode).
    """

    def __init__(self, path_imgrec, path_imgidx=None, data_shape=None,
                 batch_size=1, label_width=1,
                 shuffle=False, seed=0,
                 resize=-1, rand_crop=False, rand_mirror=False, mirror=False,
                 mean_img=None, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 mean_a=0.0, std_r=1.0, std_g=1.0, std_b=1.0, std_a=1.0,
                 scale=1.0,
                 preprocess_threads=4, prefetch_buffer=4,
                 round_batch=True, part_index=0, num_parts=1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", verbose=False, **kwargs):
        super().__init__(batch_size)
        if data_shape is None or len(data_shape) != 3:
            raise MXNetError("ImageRecordIter requires data_shape=(C,H,W)")
        self._data_shape = tuple(int(d) for d in data_shape)
        self._label_width = int(label_width)
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._resize = int(resize)
        self._rand_crop = bool(rand_crop)
        self._rand_mirror = bool(rand_mirror)
        self._mirror = bool(mirror)
        self._scale = float(scale)
        self._round_batch = bool(round_batch)
        self._dtype = dtype
        self._data_name, self._label_name = data_name, label_name

        c = self._data_shape[0]
        if c > 4:
            raise MXNetError("ImageRecordIter supports at most 4 channels")
        self._mean = _np.array([mean_r, mean_g, mean_b, mean_a][:c],
                               _np.float32)
        self._std = _np.array([std_r, std_g, std_b, std_a][:c], _np.float32)
        self._mean_img_path = str(mean_img) if mean_img is not None else None
        self._mean_arr = None  # loaded/computed after the reader opens

        # MXIndexedRecordIO.open rebuilds a missing .idx with the native
        # framing scanner (bounded memory for big packs) — one reader path
        # whether or not path_imgidx was given
        self._rec = _recordio.MXIndexedRecordIO(
            path_imgidx or path_imgrec + ".idx", path_imgrec, "r")
        keys = list(self._rec.keys)
        self._path_imgrec = path_imgrec

        # partition for distributed reading (part_index/num_parts), exactly
        # the reference's kth-of-n slicing
        n = len(keys)
        per = (n + num_parts - 1) // num_parts
        self._keys = keys[part_index * per:(part_index + 1) * per]
        if not self._keys:
            raise MXNetError("ImageRecordIter: empty partition")

        self._pool = ThreadPoolExecutor(max_workers=max(1, preprocess_threads))
        self._prefetch = _BackgroundPrefetcher(self._produce_batch,
                                               prefetch_buffer)
        self._reader_lock = threading.Lock()
        self._epoch = -1
        self._epoch_order = None
        self._cursor = 0
        self._exhausted = False
        if self._mean_img_path is not None:
            self._load_or_compute_mean(verbose)
        self._begin_epoch()
        self._prefetch.start()

    # -- record access ---------------------------------------------------
    def _read_record(self, key):
        with self._reader_lock:
            return self._rec.read_idx(key)

    def _load_or_compute_mean(self, verbose):
        """Load the mean image; a missing file is computed over the pack and
        saved (a `.params` file with one array, "mean_img"), as the
        reference does (src/io/iter_normalize.h)."""
        from .params_serde import load_records, save_records
        if os.path.exists(self._mean_img_path):
            _, records = load_records(self._mean_img_path)
            self._mean_arr = _np.asarray(records[0][0], _np.float32)
            return
        if verbose:
            import logging
            logging.info("ImageRecordIter: computing mean image -> %s",
                         self._mean_img_path)
        c, h, w = self._data_shape
        acc = _np.zeros((c, h, w), _np.float64)
        img = _np.empty((h, w, c), _np.uint8)
        lab = _np.empty((self._label_width,), _np.float32)
        # deterministic pass: center-crop, no mirror
        saved = (self._rand_crop, self._rand_mirror, self._mirror)
        self._rand_crop = self._rand_mirror = self._mirror = False
        try:
            for pos, key in enumerate(self._keys):
                self._decode_one(int(key), pos, img, lab)
                acc += img.astype(_np.float64).transpose(2, 0, 1)
        finally:
            self._rand_crop, self._rand_mirror, self._mirror = saved
        self._mean_arr = (acc / len(self._keys)).astype(_np.float32)
        save_records(self._mean_img_path, ["mean_img"],
                     [(self._mean_arr, "float32")])

    # -- epoch / batch production ---------------------------------------
    def _begin_epoch(self):
        self._epoch += 1
        order = _np.array(self._keys)
        if self._shuffle:
            # epoch-seeded shuffle: reproducible regardless of how many
            # augmentation draws earlier epochs consumed
            _np.random.RandomState(
                (self._seed * 2654435761 + self._epoch) % (1 << 32)
            ).shuffle(order)
        self._epoch_order = order
        self._cursor = 0
        self._exhausted = False

    def _decode_one(self, key, pos, out_hwc, label_out):
        from .. import image as _image
        # per-record RNG seeded by (seed, epoch, position): deterministic
        # augmentation independent of decode-thread scheduling (the
        # reference seeds each decode thread; per-record is stricter)
        rng = _np.random.RandomState(
            (self._seed * 1000003 + self._epoch * 7919 + pos) % (1 << 32))
        s = self._read_record(key)
        header, img_bytes = _recordio.unpack(s)
        lab = _np.atleast_1d(_np.asarray(header.label, _np.float32))
        label_out[:] = lab[:self._label_width]
        img = _image.imdecode(img_bytes, to_ndarray=False)

        c, h, w = self._data_shape
        if self._resize > 0:
            img = _resize_short(img, self._resize)
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = _resize_short(img, max(h, w))
            ih, iw = img.shape[:2]
        if self._rand_crop:
            y0 = rng.randint(0, ih - h + 1)
            x0 = rng.randint(0, iw - w + 1)
        else:  # center crop, reference default
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        img = img[y0:y0 + h, x0:x0 + w]
        if img.shape[2] != c:
            img = img[:, :, :c] if img.shape[2] > c else \
                _np.repeat(img, c, axis=2)
        if self._mirror or (self._rand_mirror and rng.randint(2)):
            img = img[:, ::-1]
        out_hwc[:] = img

    def _produce_batch(self):
        n = self.batch_size
        c, h, w = self._data_shape
        order = self._epoch_order
        left = len(order) - self._cursor
        if left <= 0:
            return None
        pad = 0
        base = self._cursor
        idxs = order[base:base + n]
        self._cursor += len(idxs)
        if len(idxs) < n:
            pad = n - len(idxs)
            # round_batch wraps the epoch head in (reference semantics for
            # dist training); otherwise the last record is repeated — both
            # emit the tail batch with `pad` set so no sample is dropped.
            # tile: the epoch may be shorter than the pad itself
            fill = _np.tile(order, pad // len(order) + 1)[:pad] \
                if self._round_batch else _np.repeat(idxs[-1:], pad)
            idxs = _np.concatenate([idxs, fill])

        batch_hwc = _np.empty((n, h, w, c), _np.uint8)
        labels = _np.empty((n, self._label_width), _np.float32)
        futs = [self._pool.submit(self._decode_one, int(k), base + i,
                                  batch_hwc[i], labels[i])
                for i, k in enumerate(idxs)]
        for f in futs:
            f.result()

        from ..native import batch_to_chw_norm
        # the pass computes (x/255 - m)/s; with m=mean/255, s=std/255 that
        # is exactly (x - mean)/std in 0..255 pixel units — the reference's
        # mean_r/std_r convention
        chw = batch_to_chw_norm(batch_hwc, mean=self._mean / 255.0,
                                std=self._std / 255.0)
        if self._mean_arr is not None:
            chw -= self._mean_arr
        if self._scale != 1.0:
            chw *= self._scale
        return chw.astype(self._dtype, copy=False), labels, pad

    # -- DataIter protocol ----------------------------------------------
    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size,) +
                         self._data_shape, self._dtype)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self._label_width == 1 else \
            (self.batch_size, self._label_width)
        return [DataDesc(self._label_name, shp, _np.float32)]

    def reset(self):
        self._prefetch.stop()
        self._begin_epoch()
        self._prefetch.start()

    def next(self):
        if self._exhausted:  # epoch already ended; don't block on the queue
            raise StopIteration
        try:
            item = self._prefetch.get()
        except Exception:
            self._exhausted = True  # producer died; reset() revives
            raise
        if isinstance(item, _EndOfEpoch):
            self._exhausted = True
            raise StopIteration
        chw, labels, pad = item
        lab = _np.ascontiguousarray(labels[:, 0]) \
            if self._label_width == 1 else labels
        return DataBatch(data=[_on_current(chw)], label=[_on_current(lab)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __del__(self):
        try:
            self._prefetch.stop()
            self._pool.shutdown(wait=False)
        except Exception:
            pass


class CSVIter(DataIter):
    """`mx.io.CSVIter` — fixed-shape rows out of headerless CSV files,
    STREAMED batch-by-batch with bounded memory (the reference parses with
    dmlc's chunked CSVParser; a multi-GB csv must not be materialized).
    reference: src/io/iter_csv.cc (CSVIterParam: data_csv, data_shape,
    label_csv, label_shape, batch_size, round_batch)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=None,
                 batch_size=1, round_batch=True, dtype="float32",
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self._data_shape = tuple(int(d) for d in (
            data_shape if isinstance(data_shape, (tuple, list))
            else (data_shape,)))
        self._label_shape = tuple(int(d) for d in (
            label_shape if isinstance(label_shape, (tuple, list))
            else ((label_shape,) if label_shape else (1,))))
        self._round_batch = bool(round_batch)
        self._dtype = dtype
        self._data_name, self._label_name = data_name, label_name
        self._data_csv, self._label_csv = data_csv, label_csv
        self._per_row = 1
        for d in self._data_shape:
            self._per_row *= d
        self._label_per_row = 1
        for d in self._label_shape:
            self._label_per_row *= d
        self._head_data = None   # first rows, for round_batch wrap
        self._head_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape, self._dtype)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self._label_shape == (1,) else \
            (self.batch_size,) + self._label_shape
        return [DataDesc(self._label_name, shp, _np.float32)]

    def reset(self):
        if getattr(self, "_data_f", None) is not None:
            self._data_f.close()
        if getattr(self, "_label_f", None) is not None:
            self._label_f.close()
        self._data_f = open(self._data_csv)
        self._label_f = open(self._label_csv) if self._label_csv else None
        self._data_rem = []   # values parsed but not yet emitted (a file
        self._label_rem = []  # line need not align with a logical row)
        self._exhausted = False
        self._row = 0

    @staticmethod
    def _read_rows(f, rem, want_rows, per_row):
        """Parse up to want_rows rows; `rem` carries surplus values across
        calls so rows may wrap lines (like np.loadtxt reshape) and a long
        line may hold several rows, without ever losing values."""
        vals = rem
        while len(vals) < want_rows * per_row:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            vals.extend(float(v) for v in line.split(","))
        n_full = min(want_rows, len(vals) // per_row)
        out = _np.asarray(vals[:n_full * per_row],
                          _np.float32).reshape(n_full, per_row)
        del vals[:n_full * per_row]
        if n_full < want_rows and vals:
            raise MXNetError(
                "CSVIter: file ends mid-row (%d trailing values, row width "
                "%d)" % (len(vals), per_row))
        return out

    def next(self):
        if self._exhausted:
            raise StopIteration
        n = self.batch_size
        data = self._read_rows(self._data_f, self._data_rem, n,
                               self._per_row)
        if self._label_f is not None:
            lab = self._read_rows(self._label_f, self._label_rem, n,
                                  self._label_per_row)
            if len(lab) < len(data):
                raise MXNetError("CSVIter: label rows ran out before data")
            lab = lab[:len(data)]
        else:
            lab = _np.zeros((len(data), self._label_per_row), _np.float32)
        got = len(data)
        if got == 0:
            self._exhausted = True
            raise StopIteration
        if self._row == 0:  # remember the head for round_batch wrapping
            self._head_data, self._head_label = data.copy(), lab.copy()
        self._row += got
        pad = n - got
        if pad:
            self._exhausted = True
            if self._round_batch and self._head_data is not None:
                reps = pad // len(self._head_data) + 1
                fill_d = _np.tile(self._head_data, (reps, 1))[:pad]
                fill_l = _np.tile(self._head_label, (reps, 1))[:pad]
            else:  # repeat the last row
                fill_d = _np.repeat(data[-1:], pad, axis=0)
                fill_l = _np.repeat(lab[-1:], pad, axis=0)
            data = _np.concatenate([data, fill_d])
            lab = _np.concatenate([lab, fill_l])
        data = data.reshape((n,) + self._data_shape).astype(self._dtype,
                                                            copy=False)
        lab = lab[:, 0] if self._label_shape == (1,) else \
            lab.reshape((n,) + self._label_shape)
        return DataBatch(data=[array(data)], label=[array(lab)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def _read_idx_ubyte(path):
    """Parse an idx-ubyte file (MNIST format): magic 0x801 (labels,
    1-D uint8) / 0x803 (images, 3-D uint8)."""
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = _np.frombuffer(f.read(), _np.uint8)
    return data.reshape(dims)


class MNISTIter(DataIter):
    """`mx.io.MNISTIter` — the classic idx-ubyte reader.
    reference: src/io/iter_mnist.cc (MNISTParam: image, label, batch_size,
    shuffle, flat, seed, part_index/num_parts, silent)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=False, part_index=0, num_parts=1,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        imgs = _read_idx_ubyte(image)
        labs = _read_idx_ubyte(label)
        if len(imgs) != len(labs):
            raise MXNetError("MNISTIter: image/label count mismatch")
        n = len(imgs)
        per = (n + num_parts - 1) // num_parts
        sl = slice(part_index * per, (part_index + 1) * per)
        imgs, labs = imgs[sl], labs[sl]
        self._flat = bool(flat)
        data = imgs.astype(_np.float32) / 255.0
        self._data = data.reshape(len(data), -1) if flat else \
            data[:, None, :, :]  # NCHW with C=1, reference layout
        self._labels = labs.astype(_np.float32)
        self._shuffle = bool(shuffle)
        self._rng = _np.random.RandomState(seed)
        self._order = _np.arange(len(self._data))
        self._data_name, self._label_name = data_name, label_name
        if not silent:
            import logging
            logging.info("MNISTIter: loaded %d images, shape %s",
                         len(self._data), self._data.shape[1:])
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data.shape[1:])]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,), _np.float32)]

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def next(self):
        n = self.batch_size
        if self._cursor + n > len(self._order):  # drop tail, reference does
            raise StopIteration
        idx = self._order[self._cursor:self._cursor + n]
        self._cursor += n
        return DataBatch(data=[array(self._data[idx])],
                         label=[array(self._labels[idx])], pad=0,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


_DET_ITER_KNOWN = {
    "path_imglist", "path_root", "imglist", "aug_list", "data_name",
    "label_name", "shuffle", "part_index", "num_parts", "dtype",
    "last_batch_handle", "resize", "rand_crop", "rand_pad", "rand_gray",
    "rand_mirror", "mean", "std", "brightness", "contrast", "saturation",
    "pca_noise", "hue", "inter_method", "min_object_covered",
    "aspect_ratio_range", "area_range", "min_eject_coverage",
    "max_attempts", "pad_val", "label_width"}


def ImageDetRecordIter(path_imgrec=None, batch_size=None, data_shape=None,
                       mean_r=None, mean_g=None, mean_b=None, std_r=None,
                       std_g=None, std_b=None, **kwargs):
    """`mx.io.ImageDetRecordIter` — detection-record iterator name from the
    reference's C++ surface (src/io/iter_image_det_recordio.cc); a factory
    over the label-aware `mx.image.ImageDetIter` for the same .rec files.
    The C++ per-channel mean_r/std_r args translate to the mean/std chain;
    unknown kwargs raise instead of silently dropping augmentations."""
    from ..image_detection import ImageDetIter
    if any(v is not None for v in (mean_r, mean_g, mean_b)):
        kwargs.setdefault("mean", (mean_r or 0.0, mean_g or 0.0,
                                   mean_b or 0.0))
    if any(v is not None for v in (std_r, std_g, std_b)):
        kwargs.setdefault("std", (std_r or 1.0, std_g or 1.0, std_b or 1.0))
    unknown = set(kwargs) - _DET_ITER_KNOWN
    if unknown:
        raise MXNetError(
            "ImageDetRecordIter: unsupported arguments %s (the C++ "
            "iterator's remaining knobs are not implemented here — pass an "
            "explicit aug_list instead)" % sorted(unknown))
    return ImageDetIter(batch_size=batch_size, data_shape=data_shape,
                        path_imgrec=path_imgrec, **kwargs)


class ImageRecordUInt8Iter(ImageRecordIter):
    """`mx.io.ImageRecordUInt8Iter` — ImageRecordIter emitting raw uint8
    pixels (no mean/std/scale applied). reference: iter_image_recordio_2.cc
    (ImageRecordUInt8Iter)."""

    def __init__(self, *args, **kwargs):
        kwargs["dtype"] = "uint8"
        for k in ("mean_r", "mean_g", "mean_b", "std_r", "std_g", "std_b",
                  "scale", "mean_img"):
            kwargs.pop(k, None)
        super().__init__(*args, **kwargs)
