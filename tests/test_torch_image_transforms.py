"""The port's `mx.image` augmenters and `gluon.data.vision.transforms`
against the JAX package's.

Both packages get the same seeded image and, before each call, the same
`random.seed` and `np.random.seed`: the crops and jitters draw from those
in the same order, so the outputs agree. Tolerances:

- `imresize` (the reference's ``jax.image.resize``, the port's
  antialiased ``interpolate``): uint8 within 1 (a rounding on either side
  of .5), fp32 within 2e-4 on the 0-255 scale when shrinking and 5e-3
  when growing; nearest (interp 0) exactly;
- a crop or augmenter without a resize: uint8 exactly, fp32 within 1e-5
  of the output's max abs;
- with a resize inside: the resize's own tolerance.

The flips draw their coin from each package's own generator, so they are
held by their two branches and their rate.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.data.vision import transforms as T
from mxnet_tpu.gluon.data.vision import transforms as JT

REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _image(shape=(40, 53, 3), seed=0, dtype=np.uint8):
    img = np.random.RandomState(seed).randint(0, 256, shape)
    return img.astype(dtype)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _run(fn_mine, fn_ref, img, dtype, seed=1):
    _seed(seed)
    a = fn_mine(mx.nd.array(img, dtype=dtype))
    _seed(seed)
    b = fn_ref(jmx.nd.array(img, dtype=dtype))
    return a, b


def _arr(x):
    return (x[0] if isinstance(x, tuple) else x).asnumpy()


def _hold(a, b, dtype, resized, growing=False):
    a, b = _arr(a), _arr(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
    if a.dtype == np.uint8:
        assert d <= (1 if resized else 0), d
    elif resized:
        assert d <= (5e-3 if growing else 2e-4), d
    else:
        assert d <= REL * max(np.abs(b).max(), 1e-30), d


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("size", [(31, 22), (90, 70), (53, 17)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_imresize_every_interp(interp, size, dtype):
    img = _image()
    w, h = size
    a = mx.image.imresize(mx.nd.array(img, dtype=dtype), w, h, interp)
    b = jmx.image.imresize(jmx.nd.array(img, dtype=dtype), w, h, interp)
    if interp == 0:
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    else:
        _hold(a, b, dtype, resized=True, growing=w > 53 or h > 40)


def test_imresize_gray_plane_and_numpy_input():
    img = _image((30, 20))
    a = mx.image.imresize(img, 11, 13, 1)
    b = jmx.image.imresize(img, 11, 13, 1)
    _hold(a, b, "uint8", resized=True)


CROPS = {
    "fixed_crop": (lambda m: lambda x: m.image.fixed_crop(x, 3, 5, 20, 17),
                   False),
    "fixed_crop_resize": (lambda m: lambda x: m.image.fixed_crop(
        x, 3, 5, 20, 17, size=(12, 9), interp=1), True),
    "random_crop": (lambda m: lambda x: m.image.random_crop(x, (21, 19)),
                    False),
    "random_crop_resize": (lambda m: lambda x: m.image.random_crop(
        x, (21, 19), interp=1), False),
    "center_crop": (lambda m: lambda x: m.image.center_crop(x, (30, 11)),
                    False),
    "resize_short": (lambda m: lambda x: m.image.resize_short(x, 24), True),
    "random_size_crop": (lambda m: lambda x: m.image.random_size_crop(
        x, (16, 16), 0.08, (3 / 4, 4 / 3), 1), True),
    "random_size_crop_fallback": (lambda m: lambda x: m.image.random_size_crop(
        x, (16, 16), (0.99, 1.0), (3.0, 4.0), 2), True),
}


@pytest.mark.parametrize("name", sorted(CROPS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_crops(name, seed):
    make, resized = CROPS[name]
    a, b = _run(make(mx), make(jmx), _image(), "uint8", seed)
    if isinstance(a, tuple):
        assert a[1] == b[1]
    _hold(a, b, "uint8", resized)


def test_color_normalize():
    img = _image(dtype=np.float32)
    mean, std = np.array([120., 110., 100.]), np.array([50., 60., 70.])
    a = mx.image.color_normalize(mx.nd.array(img), mx.nd.array(mean),
                                 mx.nd.array(std))
    b = jmx.image.color_normalize(jmx.nd.array(img), jmx.nd.array(mean),
                                  jmx.nd.array(std))
    _hold(a, b, "float32", False)


def _augs(m):
    """name -> (augmenter, resized)."""
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    im = m.image
    return {
        "ResizeAug": (im.ResizeAug(25, 1), True),
        "ForceResizeAug": (im.ForceResizeAug((30, 20), 2), True),
        "RandomCropAug": (im.RandomCropAug((20, 15)), False),
        "RandomSizedCropAug": (im.RandomSizedCropAug(
            (16, 16), 0.3, (0.75, 1.33), 1), True),
        "CenterCropAug": (im.CenterCropAug((20, 15)), False),
        "HorizontalFlipAug": (im.HorizontalFlipAug(0.5), False),
        "CastAug": (im.CastAug(), False),
        "ColorNormalizeAug": (im.ColorNormalizeAug(
            np.array([123.68, 116.28, 103.53]),
            np.array([58.395, 57.12, 57.375])), False),
        "BrightnessJitterAug": (im.BrightnessJitterAug(0.4), False),
        "ContrastJitterAug": (im.ContrastJitterAug(0.4), False),
        "SaturationJitterAug": (im.SaturationJitterAug(0.4), False),
        "HueJitterAug": (im.HueJitterAug(0.3), False),
        "ColorJitterAug": (im.ColorJitterAug(0.4, 0.4, 0.4), False),
        "LightingAug": (im.LightingAug(0.1, eigval, eigvec), False),
        "RandomGrayAug": (im.RandomGrayAug(0.5), False),
        "SequentialAug": (im.SequentialAug([
            im.CastAug(), im.BrightnessJitterAug(0.2)]), False),
        "RandomOrderAug": (im.RandomOrderAug([
            im.BrightnessJitterAug(0.3), im.ContrastJitterAug(0.3),
            im.SaturationJitterAug(0.3)]), False),
    }


@pytest.mark.parametrize("name", sorted(_augs(mx)))
@pytest.mark.parametrize("seed", [1, 2])
def test_augmenter(name, seed):
    mine, resized = _augs(mx)[name]
    ref, _ = _augs(jmx)[name]
    dtype = "uint8" if name in ("ResizeAug", "ForceResizeAug", "CastAug",
                                "RandomCropAug", "RandomSizedCropAug",
                                "CenterCropAug", "HorizontalFlipAug") \
        else "float32"
    a, b = _run(mine, ref, _image(), dtype, seed)
    _hold(a, b, dtype, resized)
    assert mine.dumps() == ref.dumps()


@pytest.mark.parametrize("kwargs", [
    {}, {"resize": 30, "rand_crop": True},
    {"rand_crop": True, "rand_resize": True, "rand_mirror": True},
    {"mean": True, "std": True, "brightness": 0.3, "contrast": 0.3,
     "saturation": 0.3, "hue": 0.1, "pca_noise": 0.1, "rand_gray": 0.3}])
def test_create_augmenter(kwargs):
    mine = mx.image.CreateAugmenter((3, 16, 16), inter_method=1, **kwargs)
    ref = jmx.image.CreateAugmenter((3, 16, 16), inter_method=1, **kwargs)
    assert [type(a).__name__ for a in mine] == [type(a).__name__
                                               for a in ref]

    def chain(augs):
        def run(x):
            for aug in augs:
                x = aug(x)
            return x
        return run
    a, b = _run(chain(mine), chain(ref), _image(), "uint8", 4)
    if not kwargs:
        _hold(a, b, "float32", resized=False)
    else:
        # a uint8 resize (within 1) ahead of the cast, scaled by up to
        # three jitters of at most 1.3 and by 1 / std
        tol = 1.3 ** 3 / 57.12 if "std" in kwargs else 1.0
        assert np.abs(_arr(a) - _arr(b)).max() <= tol


def _transforms(t):
    """name -> (transform, input dtype, resized)."""
    return {
        "Cast": (t.Cast("float16"), "uint8", False),
        "ToTensor": (t.ToTensor(), "uint8", False),
        "Normalize": (t.Compose([t.ToTensor(), t.Normalize(
            [0.485, 0.456, 0.406], [0.229, 0.224, 0.225])]), "uint8", False),
        "Resize": (t.Resize(20), "uint8", True),
        "Resize_keep_ratio": (t.Resize(20, keep_ratio=True), "uint8", True),
        "Resize_tuple": (t.Resize((25, 14), interpolation=2), "float32",
                         True),
        "CenterCrop": (t.CenterCrop(20), "uint8", False),
        "RandomCrop": (t.RandomCrop((20, 18)), "uint8", False),
        "RandomCrop_pad": (t.RandomCrop(30, pad=4), "uint8", False),
        "RandomResizedCrop": (t.RandomResizedCrop(24), "uint8", True),
        "CropResize": (t.CropResize(4, 3, 20, 16), "uint8", False),
        "CropResize_size": (t.CropResize(4, 3, 20, 16, size=(10, 8)),
                            "uint8", True),
        "RandomBrightness": (t.RandomBrightness(0.4), "uint8", False),
        "RandomContrast": (t.RandomContrast(0.4), "uint8", False),
        "RandomSaturation": (t.RandomSaturation(0.4), "uint8", False),
        "RandomHue": (t.RandomHue(0.2), "uint8", False),
        "RandomColorJitter": (t.RandomColorJitter(0.4, 0.4, 0.4, 0.1),
                              "uint8", False),
        "RandomLighting": (t.RandomLighting(0.1), "float32", False),
        "RandomGray": (t.RandomGray(0.5), "uint8", False),
    }


@pytest.mark.parametrize("name", sorted(_transforms(T)))
@pytest.mark.parametrize("seed", [1, 2])
def test_transform(name, seed):
    mine, dtype, resized = _transforms(T)[name]
    ref, _, _ = _transforms(JT)[name]
    a, b = _run(mine, ref, _image(), dtype, seed)
    if a.dtype == np.float16:
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    else:
        _hold(a, b, dtype, resized)


@pytest.mark.parametrize("flip,axis", [(T.RandomFlipLeftRight, 1),
                                       (T.RandomFlipTopBottom, 0)])
def test_flips_by_branch_and_rate(flip, axis):
    img = _image((6, 7, 3))
    x = mx.nd.array(img, dtype="uint8")
    block = flip()
    mx.random.seed(3)
    flipped = 0
    for _ in range(400):
        out = block(x).asnumpy()
        assert out.dtype == np.uint8
        if np.array_equal(out, np.flip(img, axis=axis)):
            flipped += 1
        else:
            np.testing.assert_array_equal(out, img)
    assert 140 <= flipped <= 260, flipped


def test_gluoncv_training_chain():
    """GluonCV's ImageNet training transforms end to end under one seed.
    Every step after the flip commutes with it, so the port's output is
    the reference's or the reference's mirrored along the width."""
    chain = [lambda t: t.RandomResizedCrop(32),
             lambda t: t.RandomFlipLeftRight(),
             lambda t: t.RandomColorJitter(0.4, 0.4, 0.4),
             lambda t: t.RandomLighting(0.1),
             lambda t: t.ToTensor(),
             lambda t: t.Normalize([0.485, 0.456, 0.406],
                                   [0.229, 0.224, 0.225])]
    mine = T.Compose([c(T) for c in chain])
    ref = JT.Compose([c(JT) for c in chain])
    img = _image((48, 64, 3), seed=8)
    for seed in range(6):
        a, b = _run(mine, ref, img, "uint8", seed)
        a, b = a.asnumpy(), b.asnumpy()
        assert a.shape == (3, 32, 32) and a.dtype == np.float32
        # a uint8 crop within 1 after the resize, scaled by the jitters
        # and 1 / (255 * std)
        tol = 2.0 / 255 / 0.224 * 1.4 ** 3
        d = min(np.abs(a - b).max(), np.abs(a - b[:, :, ::-1]).max())
        assert d <= tol, d
