"""The int8 quantization ops (`ops/quantization_ops.py`) against the JAX
package's on the same seeded inputs: every int8 and int32 result exact,
and every range (a float32 scalar) exact. The quantized product and
convolution sum their integer products in float64 in the port, which is
exact, as the reference's int32 accumulation is."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _run(pkg, op, args, kwargs):
    with pkg.cpu():
        vals = [pkg.nd.array(a, dtype=a.dtype) if isinstance(a, np.ndarray)
                else a for a in args]
        out = pkg.nd.invoke(op, *vals, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [np.asarray(o.asnumpy()) for o in outs]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _i8(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(
        np.int8)


RANGE = [np.array(v, np.float32) for v in (-1.5, 1.2, -0.4, 0.6, -2.0,
                                            2.0)]


@pytest.mark.parametrize("kw", [{}, {"min_calib_range": -0.8,
                                     "max_calib_range": 1.3}])
def test_quantize_v2(kw):
    x = (np.random.RandomState(0).randn(4, 5) * 0.7).astype(np.float32)
    x[0, :3] = [0.5 / 127 * 1.3, -2.5, 0.0]     # a half step, a clip
    _same(_run(mx, "_contrib_quantize_v2", [x], kw),
          _run(jmx, "_contrib_quantize_v2", [x], kw))


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_dequantize(dtype):
    q = np.random.RandomState(1).randint(-127, 128, (3, 4)).astype(dtype)
    args = [q, RANGE[0], RANGE[1]]
    _same(_run(mx, "_contrib_dequantize", args, {}),
          _run(jmx, "_contrib_dequantize", args, {}))


@pytest.mark.parametrize("kw", [{}, {"min_calib_range": -3.0,
                                     "max_calib_range": 2.5}])
def test_requantize(kw):
    acc = np.random.RandomState(2).randint(-200000, 200000, (3, 4)).astype(
        np.int32)
    args = [acc, RANGE[4], RANGE[5]]
    _same(_run(mx, "_contrib_requantize", args, kw),
          _run(jmx, "_contrib_requantize", args, kw))


@pytest.mark.parametrize("kw", [{"num_hidden": 6},
                                {"num_hidden": 6, "no_bias": True},
                                {"num_hidden": 6, "flatten": False}])
def test_quantized_fully_connected(kw):
    x = _i8((3, 2, 8), 3) if not kw.get("flatten", True) else _i8((3, 16), 3)
    w = _i8((6, x.shape[-1]), 4)
    b = _i8((6,), 5)
    args = [x, w, b] + RANGE
    _same(_run(mx, "_contrib_quantized_fully_connected", args, kw),
          _run(jmx, "_contrib_quantized_fully_connected", args, kw))


@pytest.mark.parametrize("kw", [
    {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5},
    {"kernel": (3, 3), "stride": (2, 2), "dilate": (1, 2), "num_filter": 6,
     "num_group": 2, "no_bias": True},
    {"kernel": (2,), "num_filter": 5}])
def test_quantized_conv(kw):
    nd_ = len(kw["kernel"])
    g = kw.get("num_group", 1)
    x = _i8((2, 4) + (9, 10)[:nd_], 6)
    w = _i8((kw["num_filter"], 4 // g) + kw["kernel"], 7)
    b = _i8((kw["num_filter"],), 8)
    args = [x, w, b] + RANGE
    _same(_run(mx, "_contrib_quantized_conv", args, kw),
          _run(jmx, "_contrib_quantized_conv", args, kw))


def test_int8_round_trip_through_the_chain():
    """quantize -> quantized FC -> requantize -> dequantize: the port's
    chain equals the reference's step for step."""
    rng = np.random.RandomState(9)
    x = rng.randn(4, 8).astype(np.float32)
    w = rng.randn(3, 8).astype(np.float32)
    res = []
    for pkg in (jmx, mx):
        qx, lo, hi = _run(pkg, "_contrib_quantize_v2", [x], {})
        qw, wlo, whi = _run(pkg, "_contrib_quantize_v2", [w], {})
        acc, alo, ahi = _run(pkg, "_contrib_quantized_fully_connected",
                             [qx, qw, np.zeros(3, np.int8), lo, hi, wlo, whi,
                              RANGE[0], RANGE[1]],
                             {"num_hidden": 3, "no_bias": True})
        q8, rlo, rhi = _run(pkg, "_contrib_requantize", [acc, alo, ahi], {})
        res.append([qx, qw, acc, q8] + _run(
            pkg, "_contrib_dequantize", [q8, rlo, rhi], {}))
    _same(res[1], res[0])
    approx = x @ w.T
    assert np.abs(res[1][-1] - approx).max() < 0.1 * np.abs(approx).max()
