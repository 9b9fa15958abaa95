"""Vision transforms (the port of
`mxnet_tpu.gluon.data.vision.transforms`): the reference's blocks, HWC
uint8 in, CHW float32 out of `ToTensor`. The crops and colour jitters run
`mx.image`'s augmenters, with the reference's draws from `random` and
numpy. The flips draw their coin from the port's generator
(`mx.random.uniform` on the image's context), where the reference draws it
from its JAX key: the same rate, not the same draws.

`Normalize` and the flips make their constants on the image's context, so
a transform runs where its input lies (the host, in a DataLoader worker).
"""
from __future__ import annotations

import random

import numpy as _np

from .... import ndarray as nd
from .... import random as _mx_random
from ....image import (center_crop, imresize, random_crop, random_size_crop,
                       resize_short)
from ...block import Block, HybridBlock
from ...nn import HybridSequential, Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "CropResize", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomHue",
           "RandomColorJitter", "RandomLighting", "RandomGray"]


class Compose(Sequential):
    """Sequentially composes transforms.
    reference: transforms.py (Compose)."""

    def __init__(self, transforms):
        super().__init__()
        transforms.append(None)
        hybrid = []
        for i in transforms:
            if isinstance(i, HybridBlock):
                hybrid.append(i)
                continue
            elif len(hybrid) == 1:
                self.add(hybrid[0])
                hybrid = []
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for j in hybrid:
                    hblock.add(j)
                self.add(hblock)
                hybrid = []
            if i is not None:
                self.add(i)


class Cast(HybridBlock):
    """reference: transforms.py (Cast)."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] → CHW float32 [0,1].
    reference: transforms.py (ToTensor)."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, dtype="float32") / 255.0
        if x.ndim == 3:
            return F.transpose(x, axes=(2, 0, 1))
        return F.transpose(x, axes=(0, 3, 1, 2))


class Normalize(HybridBlock):
    """(x - mean) / std per channel on CHW.
    reference: transforms.py (Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        mean = _np.asarray(self._mean, dtype="float32").reshape(-1, 1, 1)
        std = _np.asarray(self._std, dtype="float32").reshape(-1, 1, 1)
        return (x - nd.array(mean, ctx=x.context)) / nd.array(
            std, ctx=x.context)


class Resize(Block):
    """reference: transforms.py (Resize)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._keep = keep_ratio
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        if isinstance(self._size, int):
            if not self._keep:
                wsize = hsize = self._size
                return imresize(x, wsize, hsize, self._interpolation)
            return resize_short(x, self._size, self._interpolation)
        return imresize(x, self._size[0], self._size[1], self._interpolation)


class CenterCrop(Block):
    """reference: transforms.py (CenterCrop)."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        return center_crop(x, self._size, self._interpolation)[0]


class RandomCrop(Block):
    """reference: gluon/contrib transforms RandomCrop."""

    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._pad = pad
        self._interpolation = interpolation

    def forward(self, x):
        if self._pad:
            x = nd.invoke("pad", x, pad_width=(
                self._pad, self._pad, self._pad, self._pad, 0, 0),
                mode="constant")
        return random_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    """reference: transforms.py (RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._args = (size, scale, ratio, interpolation)

    def forward(self, x):
        return random_size_crop(x, *self._args)[0]


class CropResize(HybridBlock):
    """reference: transforms.py (CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._x = x
        self._y = y
        self._width = width
        self._height = height
        self._size = size
        self._interpolation = interpolation

    def hybrid_forward(self, F, x):
        out = x[..., self._y:self._y + self._height,
                self._x:self._x + self._width, :] if x.ndim == 4 else \
            x[self._y:self._y + self._height, self._x:self._x + self._width]
        if self._size:
            out = imresize(out, self._size[0], self._size[1],
                           self._interpolation or 1)
        return out


def _coin_flip_select(F, x, flipped):
    """`flipped` or `x`, by a coin drawn on x's context (no host sync)."""
    take = _mx_random.uniform(0, 1, shape=(1,), ctx=x.context) < 0.5
    return F.where(take, flipped, x)


class RandomFlipLeftRight(HybridBlock):
    """reference: transforms.py (RandomFlipLeftRight)."""

    def hybrid_forward(self, F, x):
        return _coin_flip_select(F, x, F.reverse(x, axis=x.ndim - 2))


class RandomFlipTopBottom(HybridBlock):
    """reference: transforms.py (RandomFlipTopBottom)."""

    def hybrid_forward(self, F, x):
        return _coin_flip_select(F, x, F.reverse(x, axis=x.ndim - 3))


class RandomBrightness(Block):
    """reference: transforms.py (RandomBrightness)."""

    def __init__(self, brightness):
        super().__init__()
        self._args = max(0, 1 - brightness), 1 + brightness

    def forward(self, x):
        alpha = random.uniform(*self._args)
        return x.astype("float32") * alpha


class RandomContrast(Block):
    """reference: transforms.py (RandomContrast)."""

    def __init__(self, contrast):
        super().__init__()
        self._args = max(0, 1 - contrast), 1 + contrast

    def forward(self, x):
        from ....image import ContrastJitterAug
        alpha = random.uniform(*self._args) - 1.0
        return ContrastJitterAug(abs(alpha) + 1e-12)(x)


class RandomSaturation(Block):
    """reference: transforms.py (RandomSaturation)."""

    def __init__(self, saturation):
        super().__init__()
        self._sat = saturation

    def forward(self, x):
        from ....image import SaturationJitterAug
        return SaturationJitterAug(self._sat)(x)


class RandomHue(Block):
    """reference: transforms.py (RandomHue)."""

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        from ....image import HueJitterAug
        return HueJitterAug(self._hue)(x)


class RandomColorJitter(Block):
    """reference: transforms.py (RandomColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        from ....image import ColorJitterAug
        self._aug = ColorJitterAug(brightness, contrast, saturation)
        self._hue = hue

    def forward(self, x):
        x = self._aug(x)
        if self._hue:
            from ....image import HueJitterAug
            x = HueJitterAug(self._hue)(x)
        return x


class RandomLighting(Block):
    """reference: transforms.py (RandomLighting)."""

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        from ....image import LightingAug
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        return LightingAug(self._alpha, eigval, eigvec)(x)


class RandomGray(Block):
    """reference: contrib transforms RandomGray."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        from ....image import RandomGrayAug
        return RandomGrayAug(self._p)(x)
