"""Image augmentation on arrays (the port of the array half of
`mxnet_tpu.image`): `imresize`, the crops, `color_normalize`, the
`Augmenter` classes and `CreateAugmenter`.

`imresize` is ``torch.nn.functional.interpolate`` with antialiasing, which
is what the reference's ``jax.image.resize`` does when it shrinks: interp
2 is bicubic and 1, 3 and 4 are bilinear (uint8 images are rounded and
clipped). Interp 0 (nearest) gathers the rows and columns at
floor((i + 0.5) * in / out), computed in float32 as the reference does. The random crops and jitters draw from
Python's `random` and numpy's global generator in the reference's order,
so one `random.seed` and `np.random.seed` give both packages the same
output. Every array they make lies on the input's context.

`imdecode` reads ``.npy`` payloads (what `recordio.pack_img` writes) with
numpy, and JPEG/PNG with PIL where PIL is installed (without it such a
payload raises an ImportError that names PIL). `ImageIter` reads a .rec
pack, a .lst file with its root folder, or an in-memory list. It decodes
and augments each image on the host (`cpu()`) and puts only the finished
batch on the current context: the reference augments on its default
context and then copies each image back to the host, which on the card
would be an upload and a synchronizing download per image. The values
are the same.

The detection iterator and its augmenters (`image_detection`) are
re-exported from here, as the reference does.
"""
from __future__ import annotations

import io
import os
import random

import numpy as _np
import torch

from . import ndarray as nd
from .context import cpu

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug", "RandomOrderAug",
           "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "CreateAugmenter", "ImageIter"]

def imdecode(buf, flag=1, to_rgb=True, to_ndarray=True):
    """Decode an image's bytes to an HWC uint8 array: ``.npy`` with numpy,
    JPEG/PNG with PIL (flag 0: grayscale; to_rgb=False: BGR, as OpenCV
    gives). An NDArray on the current context, or a numpy array with
    to_ndarray=False. reference: image.py (imdecode)."""
    if isinstance(buf, nd.NDArray):
        buf = buf.asnumpy().tobytes()
    if isinstance(buf, (bytearray, memoryview)):
        buf = bytes(buf)
    if buf[:6] == b"\x93NUMPY":
        arr = _np.load(io.BytesIO(buf), allow_pickle=False)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "imdecode: the payload is not .npy, and decoding JPEG/PNG "
                "needs PIL (Pillow), which is not installed") from e
        img = Image.open(io.BytesIO(buf))
        if flag == 0:
            img = img.convert("L")
        elif img.mode != "RGB":
            img = img.convert("RGB")
        arr = _np.asarray(img)
        if not to_rgb and arr.ndim == 3:
            arr = arr[:, :, ::-1]
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if to_ndarray:
        return nd.array(arr, dtype="uint8")
    return arr


def imread(filename, flag=1, to_rgb=True):
    """reference: image.py (imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


# the reference's interp codes other than nearest (0)
_INTERP = {1: "bilinear", 2: "bicubic", 3: "bilinear", 4: "bilinear"}


def _nearest(t, h, w):
    """t's rows and columns at floor((i + 0.5) * in / out), in float32
    (``nearest-exact`` rounds differently where that is a whole
    number)."""
    for dim, n in ((0, h), (1, w)):
        m = t.shape[dim]
        if m != n:
            off = _np.floor((_np.arange(n, dtype=_np.float32) + 0.5) * m / n)
            t = t.index_select(dim, torch.from_numpy(
                off.astype(_np.int64)).to(t.device))
    return t


def _on_ctx_of(src, a):
    """A numpy constant as a float32 NDArray on src's context."""
    return nd.array(a, ctx=src.context)


def imresize(src, w, h, interp=1):
    """Resize an HWC (or HW) image to (h, w), computed in fp32 with
    antialiasing; a uint8 image is rounded and clipped back to uint8."""
    if isinstance(src, nd.NDArray):
        t, ctx = src.data_torch, src.context
    else:
        t, ctx = torch.as_tensor(_np.asarray(src)), None
    if interp == 0:
        return nd.NDArray(_nearest(t, h, w).contiguous(), ctx=ctx)
    if tuple(t.shape[:2]) == (h, w):
        # the filters weigh each pixel 1 and its neighbours 0 at scale 1
        return nd.NDArray(t.clone(memory_format=torch.contiguous_format),
                          ctx=ctx)
    x = t.float()
    plane = x.dim() == 2
    if plane:
        x = x.unsqueeze(-1)
    x = x.permute(2, 0, 1).unsqueeze(0)
    out = torch.nn.functional.interpolate(
        x, size=(h, w), mode=_INTERP.get(interp, "bilinear"),
        align_corners=False, antialias=True)
    out = out[0].permute(1, 2, 0)
    if plane:
        out = out[..., 0]
    if t.dtype == torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    else:
        out = out.to(t.dtype)
    return nd.NDArray(out.contiguous(), ctx=ctx)


def resize_short(src, size, interp=2):
    """Resize shorter edge to `size`. reference: image.py (resize_short)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """reference: image.py (fixed_crop)."""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp=interp)
    return out


def random_crop(src, size, interp=2):
    """reference: image.py (random_crop)."""
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """reference: image.py (center_crop)."""
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """reference: image.py (color_normalize)."""
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


def random_size_crop(src, size, area, ratio, interp=2):
    """reference: image.py (random_size_crop)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (float, int)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = random.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(random.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


class Augmenter:
    """Base augmenter. reference: image.py (Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, nd.NDArray):
                kwargs[k] = v.asnumpy().tolist()
            elif isinstance(v, _np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """reference: image.py (SequentialAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """reference: image.py (RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    """reference: image.py (ResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """reference: image.py (ForceResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    """reference: image.py (RandomCropAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """reference: image.py (RandomSizedCropAug)."""

    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    """reference: image.py (CenterCropAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    """reference: image.py (HorizontalFlipAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return nd.invoke("reverse", src, axis=1)
        return src


class CastAug(Augmenter):
    """reference: image.py (CastAug)."""

    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    """reference: image.py (ColorNormalizeAug)."""

    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        mean, std = self.mean, self.std
        if mean is not None and not isinstance(mean, nd.NDArray):
            mean = _on_ctx_of(src, mean)
        if std is not None and not isinstance(std, nd.NDArray):
            std = _on_ctx_of(src, std)
        return color_normalize(src.astype("float32"), mean, std)


class BrightnessJitterAug(Augmenter):
    """reference: image.py (BrightnessJitterAug)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return src.astype("float32") * alpha


class ContrastJitterAug(Augmenter):
    """reference: image.py (ContrastJitterAug)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], dtype="float32")

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        src = src.astype("float32")
        gray = (src * _on_ctx_of(src, self.coef)).sum()
        gray = (3.0 * (1.0 - alpha) / src.size) * gray
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    """reference: image.py (SaturationJitterAug)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], dtype="float32")

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        src = src.astype("float32")
        gray = (src * _on_ctx_of(src, self.coef)).sum(axis=2, keepdims=True)
        gray = gray * (1.0 - alpha)
        return src * alpha + gray


class HueJitterAug(Augmenter):
    """reference: image.py (HueJitterAug) — YIQ rotation approximation."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = _np.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], dtype="float32")
        self.ityiq = _np.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], dtype="float32")

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       dtype="float32")
        t = _np.dot(_np.dot(self.ityiq, bt), self.tyiq).T
        return nd.invoke("dot", src.astype("float32"), _on_ctx_of(src, t))


class ColorJitterAug(RandomOrderAug):
    """reference: image.py (ColorJitterAug)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA lighting jitter. reference: image.py (LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval)
        self.eigvec = _np.asarray(eigvec)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return src.astype("float32") + _on_ctx_of(src, rgb)


class RandomGrayAug(Augmenter):
    """reference: image.py (RandomGrayAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = _np.array([[0.21, 0.21, 0.21],
                              [0.72, 0.72, 0.72],
                              [0.07, 0.07, 0.07]], dtype="float32")

    def __call__(self, src):
        if random.random() < self.p:
            src = nd.invoke("dot", src.astype("float32"),
                            _on_ctx_of(src, self.mat))
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmentation pipeline.
    reference: image.py (CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0,
                                                            4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = _np.asarray(mean)
        assert mean.shape[0] in [1, 3]
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = _np.asarray(std)
        assert std.shape[0] in [1, 3]
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Batches of decoded, augmented images from a .rec pack (with the
    .idx beside it, ``splitext(path_imgrec)[0] + ".idx"``, read in its
    order, else the records in file order), a .lst file under
    `path_root`, or an in-memory ``imglist`` of (label, path) pairs.
    ``num_parts`` slices the keys by floor division and drops the
    remainder, as the reference does. Each image is decoded and augmented
    on `cpu()`; the batch (NCHW, `dtype`) is made on the current context.
    reference: python/mxnet/image/image.py (ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 part_index=0, num_parts=1, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 last_batch_handle="pad", shuffle=False, **kwargs):
        from .io.io import DataDesc
        assert path_imgrec or path_imglist or imglist is not None
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.path_root = path_root
        self.shuffle = shuffle

        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            from .recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.isfile(idx_path):
                self.imgrec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = MXRecordIO(path_imgrec, "r")
        elif path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    label = _np.array(line[1:-1], dtype="float32")
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
                self.seq = imgkeys
        elif imglist is not None:
            result = {}
            imgkeys = []
            for index, img in enumerate(imglist, 1):
                key = str(index)
                label = _np.array(img[0], dtype="float32") if not isinstance(
                    img[0], (int, float)) else _np.array([img[0]],
                                                         dtype="float32")
                result[key] = (label, img[1])
                imgkeys.append(key)
            self.imglist = result
            self.seq = imgkeys
        if num_parts > 1 and self.seq is not None:
            assert part_index < num_parts
            per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * per:(part_index + 1) * per]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self.dtype = dtype
        self.data_name = data_name
        self.label_name = label_name
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        if label_width > 1:
            self.provide_label = [DataDesc(label_name,
                                           (batch_size, label_width))]
        else:
            self.provide_label = [DataDesc(label_name, (batch_size,))]
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self, decode=True):
        """(label, image decoded on `cpu()`); decode=False gives the raw
        payload (the record's bytes or the file's name) instead."""
        from .recordio import unpack
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                header, img = unpack(self.imgrec.read_idx(idx))
                return header.label, (self._decode(img) if decode else img)
            label, fname = self.imglist[idx]
            if not decode:
                return label, fname
            with open(os.path.join(self.path_root, fname), "rb") as f:
                return label, self._decode(f.read())
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = unpack(s)
        return header.label, (self._decode(img) if decode else img)

    @staticmethod
    def _decode(buf):
        return nd.array(imdecode(buf, to_ndarray=False), ctx=cpu(),
                        dtype="uint8")

    def _fill(self, batch_data, batch_label, sample):
        """Put samples into the host batch until it is full or the data
        ends; returns how many it holds. `sample()` gives one (image as
        an HWC array, label) pair on `cpu()`."""
        i = 0
        with cpu():
            try:
                while i < self.batch_size:
                    data, label = sample()
                    batch_data[i] = data.asnumpy() if isinstance(
                        data, nd.NDArray) else data
                    batch_label[i] = label
                    i += 1
            except StopIteration:
                if i == 0:
                    raise
        for j in range(i, self.batch_size):
            batch_data[j] = batch_data[j % i]
            batch_label[j] = batch_label[j % i]
        return i

    def _batch(self, batch_data, batch_label, pad):
        from .io.io import DataBatch
        data_nchw = _np.transpose(batch_data, (0, 3, 1, 2))
        return DataBatch([nd.array(data_nchw, dtype=self.dtype)],
                         [nd.array(batch_label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self):
        """The next DataBatch."""
        c, h, w = self.data_shape
        batch_data = _np.zeros((self.batch_size, h, w, c), dtype="float32")
        batch_label = _np.zeros((self.batch_size, self.label_width),
                                dtype="float32")

        def sample():
            label, data = self.next_sample()
            return self.augmentation_transform(data), label
        n = self._fill(batch_data, batch_label, sample)
        return self._batch(batch_data, batch_label[:, 0]
                           if self.label_width == 1 else batch_label,
                           self.batch_size - n)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def augmentation_transform(self, data):
        for aug in self.auglist:
            data = aug(data)
        return data


# The detection iterator and its augmenters (reference: image/detection.py)
from .image_detection import (DetAugmenter, DetBorrowAug,   # noqa: E402,F401
                              DetRandomSelectAug, DetHorizontalFlipAug,
                              DetRandomCropAug, DetRandomPadAug,
                              CreateDetAugmenter, ImageDetIter)
__all__ += ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
            "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
            "CreateDetAugmenter", "ImageDetIter"]
