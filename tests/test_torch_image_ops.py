"""The `_image_*` ops (`ops/image_ops.py`, `nd.image`) against the JAX
package's on the same seeded images.

to_tensor, normalize, crop and the flips are exact (float32 results
within 1e-6 of the reference's largest magnitude); resize of a float
image within 1e-5, and of a uint8 image within 1 (the kept deviation of
`mx.image.imresize`: both round an antialiased fp32 resize), nearest
exact. The random ops draw from the port's generator (a kept deviation):
each result is a flip or not, with a rate near 1/2 over seeds, and the
brightness and contrast factors, solved from the outputs, lie in their
range and are uniform there (Kolmogorov-Smirnov, p > 1e-3)."""
import numpy as np
import pytest
from scipy import stats

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _run(pkg, op, img, **kw):
    with pkg.cpu():
        return pkg.nd.invoke(op, pkg.nd.array(img, dtype=img.dtype),
                             **kw).asnumpy()


def _img(shape, dtype=np.uint8, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return (rng.rand(*shape) * 255).astype(dtype)


def _close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("shape", [(5, 6, 3), (2, 5, 6, 3)])
@pytest.mark.parametrize("op,kw", [
    ("_image_to_tensor", {}),
    ("_image_crop", {"x": 1, "y": 2, "width": 3, "height": 2}),
    ("_image_flip_left_right", {}), ("_image_flip_top_bottom", {})])
def test_exact_image_ops(shape, op, kw):
    x = _img(shape)
    _close(_run(mx, op, x, **kw), _run(jmx, op, x, **kw), 1e-6)


def test_normalize():
    x = _img((2, 3, 5, 6), np.float32) / 255.0
    for data in (x, x[0]):
        kw = {"mean": (0.4, 0.5, 0.6), "std": (0.2, 0.3, 0.25)}
        _close(_run(mx, "_image_normalize", data, **kw),
               _run(jmx, "_image_normalize", data, **kw), 1e-6)


@pytest.mark.parametrize("kw", [{"size": (9, 7)}, {"size": 4},
                                {"size": 5, "keep_ratio": True},
                                {"size": (3, 2), "interp": 0},
                                {"size": (11, 13), "interp": 0}])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize(kw, dtype):
    x = _img((2, 6, 8, 3), dtype)
    got, want = _run(mx, "_image_resize", x, **kw), \
        _run(jmx, "_image_resize", x, **kw)
    if kw.get("interp") == 0:
        _close(got, want, 0)
    elif dtype == np.uint8:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        _close(got, want, 1e-5)
    one = _run(mx, "_image_resize", x[0], **kw)
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("op,axis", [("_image_random_flip_left_right", 1),
                                     ("_image_random_flip_top_bottom", 0)])
def test_random_flips(op, axis):
    x = _img((4, 5, 3))
    assert _run(jmx, op, x).shape == x.shape
    flips = 0
    with mx.cpu():
        mx.random.seed(11)
        for _ in range(400):
            out = mx.nd.invoke(op, mx.nd.array(x, dtype=x.dtype)).asnumpy()
            assert out.dtype == np.uint8
            if np.array_equal(out, np.flip(x, axis)):
                flips += 1
            else:
                np.testing.assert_array_equal(out, x)
    assert abs(flips - 200) <= 5 * 10


@pytest.mark.parametrize("op", ["_image_random_brightness",
                                "_image_random_contrast"])
def test_random_factors_are_uniform(op):
    lo, hi = 0.5, 1.5
    x = _img((4, 5, 3), np.float32, seed=3) + 1.0
    ref = _run(jmx, op, x, min_factor=lo, max_factor=hi)
    assert ref.shape == x.shape and ref.dtype == x.dtype
    coef = np.array([0.299, 0.587, 0.114], np.float32)
    mean = (x * coef).sum(-1).mean()
    factors = []
    with mx.cpu():
        mx.random.seed(12)
        for _ in range(300):
            out = mx.nd.invoke(op, mx.nd.array(x), min_factor=lo,
                               max_factor=hi).asnumpy()
            if op.endswith("brightness"):
                f = out / x
            else:
                f = (out - mean) / (x - mean)
            assert np.ptp(f) < 1e-3        # one factor per image
            factors.append(float(np.median(f)))
    factors = np.array(factors)
    assert factors.min() >= lo - 1e-4 and factors.max() <= hi + 1e-4
    assert stats.kstest(factors, stats.uniform(lo, hi - lo).cdf).pvalue \
        > 1e-3
    u8 = _img((4, 5, 3))
    with mx.cpu():
        out = mx.nd.invoke(op, mx.nd.array(u8, dtype=np.uint8),
                           min_factor=2.0, max_factor=3.0).asnumpy()
    assert out.dtype == np.uint8 and out.max() == 255      # saturated
