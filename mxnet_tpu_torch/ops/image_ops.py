"""The `_image_*` ops behind `nd.image` / `sym.image` (the port of
`mxnet_tpu.ops.image_ops`): to_tensor, normalize, resize, crop, the flips
and the random flips, brightness and contrast.

Images are HWC or NHWC for to_tensor, resize, crop and the flips;
to_tensor gives CHW/NCHW float32 in [0, 1], and normalize reads that
form. An integer image comes back rounded and clipped into its dtype.
`_image_resize` is `mx.image.imresize`'s computation (antialiased when it
shrinks, as the reference's ``jax.image.resize``; a uint8 result is within
1 of the reference's). The random ops draw their coin or factor from the
port's generator of the image's context, on the image's device.
"""
from __future__ import annotations

import torch

from ..random import generator_of
from .registry import register

__all__ = []


def _saturate_cast(out, dtype):
    """Round and clip into an integer dtype; a float dtype is a cast."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return torch.clamp(torch.round(out), info.min, info.max).to(dtype)
    return out.to(dtype)


def _uniform(lo, hi, like):
    u = torch.rand((), generator=generator_of(like.device),
                   device=like.device)
    return lo + (hi - lo) * u


@register("_image_to_tensor")
def _to_tensor(data):
    """HWC in [0, 255] -> CHW float32 in [0, 1] (NHWC -> NCHW)."""
    x = data.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if data.dim() == 3 else x.permute(0, 3, 1, 2)


@register("_image_normalize")
def _normalize(data, mean=0.0, std=1.0):
    """(x - mean) / std per channel of a CHW/NCHW float image."""
    shape = [1] * data.dim()
    shape[data.dim() - 3] = -1
    mean = torch.as_tensor(mean, dtype=data.dtype,
                           device=data.device).reshape(shape)
    std = torch.as_tensor(std, dtype=data.dtype,
                          device=data.device).reshape(shape)
    return (data - mean) / std


@register("_image_resize")
def _resize(data, size=0, keep_ratio=False, interp=1):
    """HWC/NHWC resized to size (w, h), or to a square of `size`, or with
    `keep_ratio` its shorter side to `size`; interp 0 is nearest, others
    bilinear."""
    from ..image import _nearest
    h, w = data.shape[-3], data.shape[-2]
    if isinstance(size, (tuple, list)):
        new_w, new_h = (int(v) for v in size)
    else:
        size = int(size)
        if not keep_ratio:
            new_w = new_h = size
        elif h > w:
            new_w, new_h = size, int(h * size / w)
        else:
            new_w, new_h = int(w * size / h), size
    batched = data if data.dim() == 4 else data[None]
    if interp == 0:
        out = torch.stack([_nearest(img, new_h, new_w) for img in batched])
        out = out.to(torch.float32)
    else:
        out = torch.nn.functional.interpolate(
            batched.to(torch.float32).permute(0, 3, 1, 2),
            size=(new_h, new_w), mode="bilinear", align_corners=False,
            antialias=True).permute(0, 2, 3, 1)
    out = _saturate_cast(out, data.dtype).contiguous()
    return out if data.dim() == 4 else out[0]


@register("_image_crop")
def _crop(data, x=0, y=0, width=0, height=0):
    """The (height, width) window at (y, x) of HWC/NHWC."""
    if data.dim() == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


@register("_image_flip_left_right")
def _flip_lr(data):
    return torch.flip(data, dims=(data.dim() - 2,))


@register("_image_flip_top_bottom")
def _flip_tb(data):
    return torch.flip(data, dims=(data.dim() - 3,))


def _random_flip(data, axis):
    coin = _uniform(0.0, 1.0, data) < 0.5
    return torch.where(coin, torch.flip(data, dims=(axis,)), data)


@register("_image_random_flip_left_right", random=True)
def _random_flip_lr(data):
    """Flipped left-right with probability 1/2."""
    return _random_flip(data, data.dim() - 2)


@register("_image_random_flip_top_bottom", random=True)
def _random_flip_tb(data):
    return _random_flip(data, data.dim() - 3)


@register("_image_random_brightness", random=True)
def _random_brightness(data, min_factor=1.0, max_factor=1.0):
    """x times one factor from U(min_factor, max_factor)."""
    f = _uniform(min_factor, max_factor, data)
    return _saturate_cast(data.to(torch.float32) * f, data.dtype)


@register("_image_random_contrast", random=True)
def _random_contrast(data, min_factor=1.0, max_factor=1.0):
    """x f + gray mean (1 - f), f from U(min_factor, max_factor), the gray
    mean over the H, W of the 0.299/0.587/0.114 luminance."""
    f = _uniform(min_factor, max_factor, data)
    coef = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                        device=data.device)
    x = data.to(torch.float32)
    mean = (x * coef).sum(dim=-1, keepdim=True).mean(dim=(-3, -2),
                                                     keepdim=True)
    return _saturate_cast(x * f + mean * (1 - f), data.dtype)
