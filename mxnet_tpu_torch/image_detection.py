"""The detection iterator and its label-aware augmenters (the port of
`mxnet_tpu.image_detection`).

reference: python/mxnet/image/detection.py: `ImageDetIter`,
`CreateDetAugmenter` and the `Det*Aug` family. Labels come in the
reference's packed .lst/.rec format, ``[A, B, obj0..objN]``: A is the
header width (extra header fields are skipped), B the width of an object,
and each object is ``[id, xmin, ymin, xmax, ymax, ...]`` with coordinates
normalized to [0, 1]. The iterator gives labels as a dense
``(batch, max_objects, B)`` array padded with -1 rows, which is what
`MultiBoxTarget` takes. Images are decoded and augmented on `cpu()`, as
in `image.ImageIter`; the augmenters keep an image on its own context.
"""
from __future__ import annotations

import random

import numpy as _np

from . import ndarray as nd
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    HueJitterAug, LightingAug, RandomGrayAug, ResizeAug,
                    ForceResizeAug, ImageIter, fixed_crop)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter base: __call__(src, label) -> (src, label).
    reference: detection.py (DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return [self.__class__.__name__.lower(), self._kwargs]

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection chain (labels pass
    through untouched). reference: detection.py (DetBorrowAug)."""

    def __init__(self, augmenter):
        assert isinstance(augmenter, Augmenter)
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one augmenter from a list (or skip with skip_prob).
    reference: detection.py (DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if random.random() < self.skip_prob or not self.aug_list:
            return src, label
        return random.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and flip box x-coordinates with probability p.
    reference: detection.py (DetHorizontalFlipAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = nd.array(_np.ascontiguousarray(
                src.asnumpy()[:, ::-1, :]), ctx=src.context, dtype=src.dtype)
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


def _box_area(boxes):
    return _np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
        _np.maximum(boxes[:, 3] - boxes[:, 1], 0)


class DetRandomCropAug(DetAugmenter):
    """Random crop constrained by object coverage (SSD-style).
    reference: detection.py (DetRandomCropAug)."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _update_labels(self, label, crop, height, width):
        """Crop (x0, y0, w, h) in pixels -> updated normalized labels, or
        None if every object is ejected."""
        x0, y0, cw, ch = crop
        out = label.copy()
        valid_rows = []
        for i in range(out.shape[0]):
            if out[i, 0] < 0:
                continue
            # to pixels
            x1 = out[i, 1] * width
            y1 = out[i, 2] * height
            x2 = out[i, 3] * width
            y2 = out[i, 4] * height
            area = max(x2 - x1, 0) * max(y2 - y1, 0)
            nx1, ny1 = max(x1, x0), max(y1, y0)
            nx2, ny2 = min(x2, x0 + cw), min(y2, y0 + ch)
            inter = max(nx2 - nx1, 0) * max(ny2 - ny1, 0)
            if area <= 0 or inter / area < self.min_eject_coverage:
                continue
            out[i, 1] = (nx1 - x0) / cw
            out[i, 2] = (ny1 - y0) / ch
            out[i, 3] = (nx2 - x0) / cw
            out[i, 4] = (ny2 - y0) / ch
            valid_rows.append(i)
        if not valid_rows:
            return None
        kept = out[valid_rows]
        pad = _np.full_like(out, -1.0)
        pad[:len(valid_rows)] = kept
        return pad

    def __call__(self, src, label):
        height, width = src.shape[0], src.shape[1]
        for _ in range(self.max_attempts):
            area_frac = random.uniform(*self.area_range)
            ratio = random.uniform(*self.aspect_ratio_range)
            ch = int(round((area_frac * height * width / ratio) ** 0.5))
            cw = int(round(ch * ratio))
            if ch <= 0 or cw <= 0 or ch > height or cw > width:
                continue
            y0 = random.randint(0, height - ch)
            x0 = random.randint(0, width - cw)
            # coverage check against the best-covered object
            valid = label[:, 0] >= 0
            if valid.any():
                bx = label[valid, 1:5] * [width, height, width, height]
                ix1 = _np.maximum(bx[:, 0], x0)
                iy1 = _np.maximum(bx[:, 1], y0)
                ix2 = _np.minimum(bx[:, 2], x0 + cw)
                iy2 = _np.minimum(bx[:, 3], y0 + ch)
                inter = _np.maximum(ix2 - ix1, 0) * _np.maximum(
                    iy2 - iy1, 0)
                area = _box_area(bx)
                cov = _np.where(area > 0, inter / _np.maximum(area, 1e-12),
                                0.0)
                # reference _check_satisfy_constraints: every object the
                # crop OVERLAPS must reach the coverage floor; objects the
                # crop excludes entirely (cov == 0) are allowed here and
                # ejected from the label by min_eject_coverage below
                touched = cov[cov > 0]
                if touched.size == 0 or \
                        touched.min() < self.min_object_covered:
                    continue
            new_label = self._update_labels(label, (x0, y0, cw, ch),
                                            height, width)
            if new_label is None:
                continue
            return fixed_crop(src, x0, y0, cw, ch), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expansion pad (zoom-out) with label rescale.
    reference: detection.py (DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        height, width = src.shape[0], src.shape[1]
        for _ in range(self.max_attempts):
            scale = random.uniform(*self.area_range)
            ratio = random.uniform(*self.aspect_ratio_range)
            if scale < 1.0:
                continue
            nh = int(round((scale * height * width / ratio) ** 0.5))
            nw = int(round(nh * ratio))
            if nh < height or nw < width:
                continue
            y0 = random.randint(0, nh - height)
            x0 = random.randint(0, nw - width)
            img = src.asnumpy()
            canvas = _np.empty((nh, nw, img.shape[2]), img.dtype)
            canvas[...] = _np.asarray(self.pad_val, img.dtype)
            canvas[y0:y0 + height, x0:x0 + width] = img
            out = label.copy()
            valid = out[:, 0] >= 0
            out[valid, 1] = (out[valid, 1] * width + x0) / nw
            out[valid, 2] = (out[valid, 2] * height + y0) / nh
            out[valid, 3] = (out[valid, 3] * width + x0) / nw
            out[valid, 4] = (out[valid, 4] * height + y0) / nh
            return nd.array(canvas, ctx=src.context, dtype=src.dtype), out
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmenter chain.
    reference: detection.py (CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (min(area_range[0], 1.0),
                                 min(area_range[1], 1.0)),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0),
                               max(area_range[1], 1.0)),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # force to the consumer shape AFTER geometry augs
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.814],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = _np.asarray(mean)
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = _np.asarray(std)
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: packed det labels -> dense padded label tensor.
    reference: detection.py (ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", imglist=None,
                 aug_list=None, data_name="data", label_name="label",
                 last_batch_handle="pad", **kwargs):
        det_kwargs = {}
        for k in ("resize", "rand_crop", "rand_pad", "rand_gray",
                  "rand_mirror", "mean", "std", "brightness", "contrast",
                  "saturation", "pca_noise", "hue", "inter_method",
                  "min_object_covered", "aspect_ratio_range", "area_range",
                  "min_eject_coverage", "max_attempts", "pad_val"):
            if k in kwargs:
                det_kwargs[k] = kwargs.pop(k)
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **det_kwargs)
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, imglist=imglist,
                         aug_list=[],   # det augs run in next(), label-aware
                         data_name=data_name, label_name=label_name,
                         label_width=-1 if "label_width" not in kwargs
                         else kwargs.pop("label_width"), **kwargs)
        self.det_auglist = aug_list
        self._label_shape = None
        # first pass: find max object count to fix the padded label shape
        self.max_objects, self.obj_width = self._estimate_label_shape()
        from .io.io import DataDesc
        self.provide_label = [DataDesc(
            label_name, (batch_size, self.max_objects, self.obj_width))]

    # -- packed label [A, B, objs...] -> (num_obj, B) normalized ----------
    @staticmethod
    def _parse_label(raw):
        raw = _np.asarray(raw, _np.float32).ravel()
        if raw.size < 2:
            raise ValueError("invalid det label: needs [A, B, ...] header")
        a, b = int(raw[0]), int(raw[1])
        if b < 5:
            raise ValueError("invalid det label: object width %d < 5" % b)
        objs = raw[a:]
        n = objs.size // b
        return objs[:n * b].reshape(n, b).copy()

    def _next_label(self):
        """Label of the next sample WITHOUT decoding its image — a
        construction-time scan over a big .rec must not pay the decode."""
        return self.next_sample(decode=False)[0]

    def _estimate_label_shape(self):
        max_n, width = 0, 5
        self.reset()
        try:
            while True:
                parsed = self._parse_label(self._next_label())
                max_n = max(max_n, parsed.shape[0])
                width = max(width, parsed.shape[1])
        except StopIteration:
            pass
        self.reset()
        return max(max_n, 1), width

    def next(self):
        c, h, w = self.data_shape
        batch_data = _np.zeros((self.batch_size, h, w, c), dtype="float32")
        batch_label = _np.full(
            (self.batch_size, self.max_objects, self.obj_width), -1.0,
            "float32")

        def sample():
            raw_label, data = self.next_sample()
            label = self._parse_label(raw_label)
            full = _np.full((self.max_objects, self.obj_width), -1.0,
                            _np.float32)
            full[:label.shape[0], :label.shape[1]] = label[:self.max_objects]
            for aug in self.det_auglist:
                data, full = aug(data, full)
            return data, full
        n = self._fill(batch_data, batch_label, sample)
        return self._batch(batch_data, batch_label, self.batch_size - n)
