"""The op-set slice on the card against the port's CPU results (the file
imports no JAX; the CPU files hold the CPU results to the reference).

- The detection ops: `MultiBoxPrior` exact; `MultiBoxTarget`'s class
  targets and masks exact, its box targets within 1e-6 (a log);
  `MultiBoxDetection`'s class ids, scores and order exact, boxes within
  1e-6 (an exp); `box_nms` exact at a `topk` below and at n; the ROI and
  resize ops within 1e-5.
- The 1-D and 3-D `Convolution` and the 1-, 2- and 3-D `Deconvolution`
  in fp32 (cuDNN's TF32 off inside the port's convolutions): outputs and
  the data, weight and bias gradients within 1e-5.
- The int8 ops exact.

Every test needs a CUDA card and skips without one.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

pytestmark = pytest.mark.cuda

TOL = 1e-5
EXP_LOG_TOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return mx.gpu(0)


def _run(op, args, kwargs, ctx, grad=()):
    vals = [mx.nd.array(a, ctx=ctx, dtype=a.dtype)
            if isinstance(a, np.ndarray) else a for a in args]
    for i in grad:
        vals[i].attach_grad()
    with mx.autograd.record():
        out = mx.nd.invoke(op, *vals, ctx=ctx, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        if grad:
            cot = np.random.RandomState(5).randn(*outs[0].shape).astype(
                np.float32)
            loss = (outs[0] * mx.nd.array(cot, ctx=ctx)).sum()
    if grad:
        loss.backward()
    for o in outs:
        assert o.context == ctx
    return ([o.asnumpy() for o in outs],
            [vals[i].grad.asnumpy() for i in grad])


def _close(got, want, tol, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _boxes(rng, *shape):
    xy = rng.uniform(0, .6, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(.05, .4, shape + (2,))],
                          -1).astype(np.float32)


def _ssd_case(rng, batch=4, n_maps=((8, 8), (4, 4)), classes=5):
    per = []
    with mx.cpu():
        for hw in n_maps:
            per.append(mx.nd.contrib.MultiBoxPrior(
                mx.nd.zeros((1, 1) + hw), sizes=(.2, .4),
                ratios=(1, 2, .5)).asnumpy())
    anchors = np.concatenate(per, 1)
    n = anchors.shape[1]
    label = np.full((batch, 6, 5), -1, np.float32)
    for i in range(batch):
        k = rng.randint(1, 7)
        label[i, :k, 0] = rng.randint(0, classes, k)
        label[i, :k, 1:] = _boxes(rng, k)
    prob = rng.dirichlet(np.ones(classes + 1), (batch, n)).astype(
        np.float32).transpose(0, 2, 1).copy()
    prob[:, :, ::4] = prob[:, :, :1]
    loc = (rng.randn(batch, n * 4) * .2).astype(np.float32)
    return anchors, label, prob, loc


def test_multibox_ops_on_the_card(card):
    rng = np.random.RandomState(0)
    anchors, label, prob, loc = _ssd_case(rng)
    feat = np.zeros((2, 3, 8, 8), np.float32)
    kw = {"sizes": (.2, .4), "ratios": (1, 2, .5)}
    (g,), _ = _run("_contrib_MultiBoxPrior", [feat], kw, card)
    (c,), _ = _run("_contrib_MultiBoxPrior", [feat], kw, mx.cpu())
    np.testing.assert_array_equal(g, c)
    for kw in ({}, {"negative_mining_ratio": 3.0,
                    "negative_mining_thresh": .5}):
        got, _ = _run("_contrib_MultiBoxTarget", [anchors, label, prob],
                      kw, card)
        want, _ = _run("_contrib_MultiBoxTarget", [anchors, label, prob],
                       kw, mx.cpu())
        _close(got[0], want[0], EXP_LOG_TOL, "box targets")
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    for kw in ({"nms_threshold": .45, "nms_topk": 60},
               {"nms_threshold": .3, "force_suppress": True}):
        (got,), _ = _run("_contrib_MultiBoxDetection", [prob, loc, anchors],
                         kw, card)
        (want,), _ = _run("_contrib_MultiBoxDetection",
                          [prob, loc, anchors], kw, mx.cpu())
        np.testing.assert_array_equal(got[..., :2], want[..., :2])
        _close(got[..., 2:], want[..., 2:], EXP_LOG_TOL, "boxes")


@pytest.mark.parametrize("kw", [{"id_index": 0, "topk": 30},
                                {"id_index": 0}, {"force_suppress": True,
                                                  "overlap_thresh": .3}])
def test_box_nms_on_the_card(card, kw):
    rng = np.random.RandomState(1)
    d = np.zeros((3, 80, 6), np.float32)
    d[..., 0] = rng.randint(0, 3, (3, 80))
    d[..., 1] = rng.choice([.2, .5, .7, .9], (3, 80))
    d[..., 2:] = _boxes(rng, 3, 80) * .5
    (got,), _ = _run("_contrib_box_nms", [d], kw, card)
    (want,), _ = _run("_contrib_box_nms", [d], kw, mx.cpu())
    np.testing.assert_array_equal(got, want)


ROIS = np.array([[0, 1, 1, 6, 7], [1, 0.5, 2, 9, 8], [0, 3, 3, 2, 2]],
                np.float32)
IMG = np.random.RandomState(2).rand(2, 3, 9, 11).astype(np.float32)


@pytest.mark.parametrize("op,args,kw", [
    ("_contrib_ROIAlign", [IMG, ROIS], {"pooled_size": (3, 2),
                                        "spatial_scale": .9}),
    ("_contrib_BilinearResize2D", [IMG], {"height": 5, "width": 17}),
    ("_contrib_AdaptiveAvgPooling2D", [IMG], {"output_size": (4, 3)}),
    ("_contrib_PSROIPooling",
     [np.random.RandomState(3).rand(2, 18, 9, 11).astype(np.float32), ROIS],
     {"spatial_scale": .9, "output_dim": 2, "pooled_size": 3}),
    ("_contrib_DeformableConvolution",
     [np.random.RandomState(4).rand(2, 4, 6, 7).astype(np.float32),
      (np.random.RandomState(5).randn(2, 36, 6, 7) * .8).astype(np.float32),
      np.random.RandomState(6).randn(5, 4, 3, 3).astype(np.float32)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5,
      "num_deformable_group": 2, "no_bias": True}),
])
def test_vision_ops_and_gradients_on_the_card(card, op, args, kw):
    got, gg = _run(op, args, kw, card, grad=(0,))
    want, wg = _run(op, args, kw, mx.cpu(), grad=(0,))
    _close(got[0], want[0], TOL, op)
    _close(gg[0], wg[0], TOL, op + " gradient")


@pytest.mark.parametrize("op,shapes,kw", [
    ("Convolution", [(2, 3, 9), (4, 3, 3), (4,)],
     {"kernel": (3,), "stride": (2,), "pad": (1,), "num_filter": 4}),
    ("Convolution", [(2, 9, 3), (4, 3, 3), (4,)],
     {"kernel": (3,), "dilate": (2,), "num_filter": 4, "layout": "NWC"}),
    ("Convolution", [(2, 4, 6, 7, 5), (6, 2, 3, 3, 3), (6,)],
     {"kernel": (3, 3, 3), "pad": (1, 1, 1), "num_filter": 6,
      "num_group": 2}),
    ("Convolution", [(1, 5, 6, 4, 2), (4, 3, 3, 3, 2), (4,)],
     {"kernel": (3, 3, 3), "num_filter": 4, "layout": "NDHWC"}),
    ("Deconvolution", [(2, 3, 9), (3, 4, 3), (4,)],
     {"kernel": (3,), "stride": (2,), "pad": (1,), "adj": (1,),
      "num_filter": 4, "no_bias": False}),
    ("Deconvolution", [(2, 3, 5, 4), (3, 4, 4, 4), (4,)],
     {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "num_filter": 4,
      "no_bias": False}),
    ("Deconvolution", [(2, 4, 4, 5, 3), (4, 3, 2, 3, 3), (6,)],
     {"kernel": (2, 3, 3), "stride": (1, 2, 2), "num_filter": 6,
      "num_group": 2, "no_bias": False}),
])
def test_nd_convolutions_on_the_card(card, op, shapes, kw):
    rng = np.random.RandomState(7)
    args = [rng.randn(*s).astype(np.float32) for s in shapes]
    got, gg = _run(op, args, kw, card, grad=(0, 1, 2))
    want, wg = _run(op, args, kw, mx.cpu(), grad=(0, 1, 2))
    _close(got[0], want[0], TOL, op)
    for i, (g, w) in enumerate(zip(gg, wg)):
        _close(g, w, TOL, "%s gradient %d" % (op, i))


def test_int8_ops_exact_on_the_card(card):
    rng = np.random.RandomState(8)
    rng8 = [np.array(v, np.float32) for v in (-1.5, 1.2, -.4, .6, -2., 2.)]
    i8 = lambda *s: rng.randint(-127, 128, s).astype(np.int8)  # noqa: E731
    cases = [
        ("_contrib_quantize_v2", [rng.randn(64, 33).astype(np.float32)], {}),
        ("_contrib_quantize_v2", [rng.randn(64, 33).astype(np.float32)],
         {"min_calib_range": -.8, "max_calib_range": 1.3}),
        ("_contrib_requantize", [rng.randint(-200000, 200000, (9, 7))
                                 .astype(np.int32), rng8[4], rng8[5]], {}),
        ("_contrib_dequantize", [i8(9, 7), rng8[0], rng8[1]], {}),
        ("_contrib_quantized_fully_connected",
         [i8(5, 300), i8(7, 300), i8(7)] + rng8, {"num_hidden": 7}),
        ("_contrib_quantized_conv", [i8(2, 8, 9, 10), i8(6, 8, 3, 3),
                                     i8(6)] + rng8,
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6}),
    ]
    for op, args, kw in cases:
        got, _ = _run(op, args, kw, card)
        want, _ = _run(op, args, kw, mx.cpu())
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, op
            np.testing.assert_array_equal(g, w, err_msg=op)
