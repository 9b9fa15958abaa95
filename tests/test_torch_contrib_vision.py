"""The detection and contrib vision ops (`ops/contrib_vision.py`) against
the JAX package's, on the same seeded numpy inputs.

- The SSD ops: `MultiBoxPrior` exact; `MultiBoxTarget`'s cls_target and
  box_mask exact and box_target within 1e-6 (its log); `MultiBoxDetection`
  exact in class ids, scores and row order, boxes within 1e-6 (its exp).
  The labels include padding rows and boxes that overlap no anchor, and
  the class scores include ties, which the stable sorts must break as
  ``jnp.argsort`` does.
- `box_nms` exact, with ties, ids, `force_suppress`, `background_id`, a
  center format, and `topk` (the port's k x k block) against the
  reference's full n x n loop, also at topk = n.
- The other ops within 1e-5, and the gradients of the differentiable ones
  (BilinearResize2D, AdaptiveAvgPooling2D, ROIAlign, DeformableConvolution,
  PSROIPooling) within 1e-5.
- `sym.contrib.MultiBoxPrior`, `MultiBoxTarget` and `MultiBoxDetection`
  bound and run through `mx.mod.Module` give the reference Module's
  results (the class scores there come from each package's softmax, one
  ulp apart, so scores and boxes are held within 1e-6) and the port's
  imperative anchors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as ref_registry

TOL = 1e-5
EXP_LOG_TOL = 1e-6
# ops whose windows floor or ceil a quotient: under jit XLA folds a
# division by a constant into a multiplication by its reciprocal, which
# moves some windows, so the reference runs them eagerly, as its NDArray
# route does
EAGER = {"_contrib_PSROIPooling"}


def _run(pkg, op, args, kwargs=None, grad=(), cot_seed=7):
    kwargs = kwargs or {}
    with pkg.cpu():
        vals = [pkg.nd.array(a, dtype=a.dtype) if isinstance(a, np.ndarray)
                else a for a in args]
        for i in grad:
            vals[i].attach_grad()
        with pkg.autograd.record() if grad else _Null():
            out = pkg.nd.invoke(op, *vals, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            if grad:
                cot = np.random.RandomState(cot_seed).randn(
                    *outs[0].shape).astype(np.float32)
                loss = (outs[0] * pkg.nd.array(cot)).sum()
        if grad:
            loss.backward()
        return ([o.asnumpy() for o in outs],
                [vals[i].grad.asnumpy() for i in grad])


def _reference(op, args, kwargs=None, grad=(), cot_seed=7):
    """The reference's outputs and gradients: its op function under
    ``jax.vjp``, jitted (what its tape records for these ops, which have
    no hand-written rule), one compile a case; EAGER's through its
    NDArray autograd."""
    kwargs = kwargs or {}
    if op in EAGER:
        return _run(jmx, op, args, kwargs, grad, cot_seed)
    fn = ref_registry.get(op).fn
    pos = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def forward(*arrays):
        full = list(args)
        for p, a in zip(pos, arrays):
            full[p] = a
        return fn(*full, **kwargs)

    def both(*arrays):
        if not grad:
            return forward(*arrays), ()
        out, vjp = jax.vjp(forward, *arrays)
        cot = np.random.RandomState(cot_seed).randn(*out.shape).astype(
            np.float32)
        grads = vjp(jnp.asarray(cot))
        return out, tuple(grads[pos.index(i)] for i in grad)

    out, grads = jax.jit(both)(*[jnp.asarray(args[p]) for p in pos])
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _boxes(rng, shape, lo=0.0, span=0.6):
    xy = rng.uniform(lo, lo + span, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _ssd_inputs(seed=0, batch=3, classes=4, feat=(5, 7)):
    rng = np.random.RandomState(seed)
    feat_map = np.zeros((batch, 3) + feat, np.float32)
    with mx.cpu():
        anchors = mx.nd.contrib.MultiBoxPrior(
            mx.nd.array(feat_map), sizes=(.2, .35),
            ratios=(1, 2, .5)).asnumpy()
    n = anchors.shape[1]
    label = np.full((batch, 6, 5), -1, np.float32)
    for i in range(batch):
        k = rng.randint(1, 6)
        label[i, :k, 0] = rng.randint(0, classes, k)
        label[i, :k, 1:] = _boxes(rng, (k,))
    label[0, 1, 1:] = [2.0, 2.0, 2.1, 2.1]      # overlaps no anchor
    cls_prob = rng.dirichlet(np.ones(classes + 1), (batch, n)).astype(
        np.float32).transpose(0, 2, 1).copy()
    cls_prob[:, :, ::5] = cls_prob[:, :, :1]    # tied columns
    cls_prob[1, 0, 3:12] = 0.25                 # tied background scores
    loc = (rng.randn(batch, n * 4) * 0.2).astype(np.float32)
    return feat_map, anchors, label, cls_prob, loc


@pytest.mark.parametrize("kw", [
    {"sizes": (.2, .35), "ratios": (1, 2, .5)},
    {"sizes": (.3,), "ratios": (1, 3, 1 / 3.), "clip": True},
    {"sizes": (.1, .141), "ratios": (1, 2, .5), "steps": (.25, .2),
     "offsets": (.4, .6)}])
def test_multibox_prior(kw):
    feat = np.zeros((2, 3, 4, 6), np.float32)
    want, _ = _reference("_contrib_MultiBoxPrior", [feat], kw)
    got, _ = _run(mx, "_contrib_MultiBoxPrior", [feat], kw)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("kw", [
    {},
    {"negative_mining_ratio": 3.0, "ignore_label": -1.0,
     "negative_mining_thresh": 0.5},
    {"negative_mining_ratio": 2.0, "minimum_negative_samples": 30,
     "overlap_threshold": 0.3, "variances": (0.1, 0.1, 0.2, 0.2)}])
def test_multibox_target(kw):
    _, anchors, label, cls_prob, _ = _ssd_inputs()
    args = [anchors, label, cls_prob]
    want, _ = _reference("_contrib_MultiBoxTarget", args, kw)
    got, _ = _run(mx, "_contrib_MultiBoxTarget", args, kw)
    _close(got[0], want[0], EXP_LOG_TOL, "box_target")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert (want[2] > 0).sum() > 3      # some anchors matched


@pytest.mark.parametrize("kw", [
    {"nms_threshold": 0.45, "nms_topk": 40},
    {"nms_threshold": 0.45},
    {"nms_threshold": 0.3, "force_suppress": True, "threshold": 0.2,
     "clip": False, "nms_topk": 25}])
def test_multibox_detection(kw):
    _, anchors, _, cls_prob, loc = _ssd_inputs(seed=1)
    args = [cls_prob, loc, anchors]
    (want,), _ = _reference("_contrib_MultiBoxDetection", args, kw)
    (got,), _ = _run(mx, "_contrib_MultiBoxDetection", args, kw)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    _close(got[..., 2:], want[..., 2:], EXP_LOG_TOL, "boxes")
    assert (want[..., 0] >= 0).sum() > 3


def _nms_data(seed=0, b=2, n=40):
    rng = np.random.RandomState(seed)
    d = np.zeros((b, n, 6), np.float32)
    d[..., 0] = rng.randint(0, 3, (b, n))
    d[..., 1] = rng.choice([0.2, 0.5, 0.7, 0.9], (b, n))    # many ties
    d[..., 2:] = _boxes(rng, (b, n), span=0.3)
    return d


@pytest.mark.parametrize("kw", [
    {}, {"topk": 10}, {"topk": 40}, {"id_index": 0, "topk": 12},
    {"id_index": 0, "force_suppress": True, "overlap_thresh": 0.3},
    {"id_index": 0, "background_id": 1, "valid_thresh": 0.4},
    {"in_format": "center", "out_format": "center", "topk": 15}])
def test_box_nms_with_ties_and_topk(kw):
    d = _nms_data()
    want, _ = _reference("_contrib_box_nms", [d], kw)
    got, _ = _run(mx, "_contrib_box_nms", [d], kw)
    np.testing.assert_array_equal(got[0], want[0])
    two_d, _ = _run(mx, "_contrib_box_nms", [d[0]], kw)
    np.testing.assert_array_equal(two_d[0], want[0][0])


def test_topk_block_equals_the_full_loop():
    """Rows past k are dropped, and a kept row depends only on the rows
    before it: the port's k x k result equals its own full (k = n) loop
    with every row past k set to -1."""
    d = _nms_data(seed=3, n=60)
    (full,), _ = _run(mx, "_contrib_box_nms", [d], {"id_index": 0})
    (block,), _ = _run(mx, "_contrib_box_nms", [d], {"id_index": 0,
                                                    "topk": 20})
    expect = full.copy()
    expect[:, 20:, 1] = -1
    np.testing.assert_array_equal(block, expect)


def test_box_iou_encode_decode():
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, (2, 5)), _boxes(rng, (2, 6))
    for fmt in ("corner", "center"):
        want, _ = _reference("_contrib_box_iou", [a, b], {"format": fmt})
        got, _ = _run(mx, "_contrib_box_iou", [a, b], {"format": fmt})
        _close(got[0], want[0])
    samples = rng.rand(2, 5).astype(np.float32)
    matches = rng.randint(-1, 6, (2, 5)).astype(np.float32)
    args = [samples, matches, a, b, np.zeros(4, np.float32),
            np.ones(4, np.float32)]
    want, _ = _reference("_contrib_box_encode", args[:4])
    got, _ = _run(mx, "_contrib_box_encode", args[:4])
    for g, w in zip(got, want):
        _close(g, w, EXP_LOG_TOL)
    off = (rng.randn(2, 5, 4) * .3).astype(np.float32)
    for kw in ({}, {"clip": 0.2}, {"format": "center", "std0": 0.2}):
        want, _ = _reference("_contrib_box_decode", [off, a], kw)
        got, _ = _run(mx, "_contrib_box_decode", [off, a], kw)
        _close(got[0], want[0], EXP_LOG_TOL)


X = np.random.RandomState(5).rand(2, 3, 9, 11).astype(np.float32)
ROIS = np.array([[0, 1, 1, 6, 7], [1, 0.5, 2, 9, 8], [0, 3, 3, 2, 2],
                 [1, -2, -1, 12, 14]], np.float32)


@pytest.mark.parametrize("op,args,kw", [
    ("_contrib_BilinearResize2D", [X], {"height": 5, "width": 17}),
    ("_contrib_bilinear_resize2d", [X], {"scale_height": 1.5,
                                         "scale_width": 0.5}),
    ("_contrib_AdaptiveAvgPooling2D", [X], {"output_size": (4, 3)}),
    ("_contrib_adaptive_avg_pooling2d", [X], {"output_size": 5}),
    ("_contrib_ROIAlign", [X, ROIS], {"pooled_size": (3, 2),
                                      "spatial_scale": 0.9}),
    ("_contrib_ROIAlign", [X, ROIS], {"pooled_size": 2, "sample_ratio": 3,
                                      "aligned": True}),
    ("_contrib_PSROIPooling",
     [np.random.RandomState(6).rand(2, 2 * 3 * 3, 9, 11).astype(np.float32),
      ROIS], {"spatial_scale": 0.9, "output_dim": 2, "pooled_size": 3}),
    ("_contrib_DeformableConvolution",
     [np.random.RandomState(7).rand(2, 4, 6, 7).astype(np.float32),
      (np.random.RandomState(8).randn(2, 2 * 2 * 4, 7, 8) * .8).astype(
          np.float32),
      np.random.RandomState(9).randn(5, 4, 2, 2).astype(np.float32),
      np.random.RandomState(10).randn(5).astype(np.float32)],
     {"kernel": (2, 2), "pad": (1, 1), "stride": (1, 1), "num_filter": 5,
      "num_deformable_group": 2}),
])
def test_differentiable_vision_ops(op, args, kw):
    grad = [i for i in range(len(args)) if i == 0 or (
        op.endswith("Convolution"))]
    if kw.get("aligned"):
        grad = []   # the same gradient code as the case before it
    want, wg = _reference(op, args, kw, grad)
    got, gg = _run(mx, op, args, kw, grad)
    _close(got[0], want[0], TOL, op)
    for i, g, w in zip(grad, gg, wg):
        _close(g, w, TOL, "%s gradient %d" % (op, i))


@pytest.mark.parametrize("kw", [{}, {"start": 2, "step": .5, "repeat": 3},
                                {"axis": 1}])
def test_arange_like(kw):
    want, _ = _reference("_contrib_arange_like", [X], kw)
    got, _ = _run(mx, "_contrib_arange_like", [X], kw)
    _close(got[0], want[0])


def _ssd_graph(pkg):
    """A 4x4 map with 3 anchors a cell (48), 2 classes + background: a
    9-filter conv reshaped to (B, 3, 48) class scores, a 12-filter conv to
    (B, 192) box offsets."""
    data = pkg.sym.var("data")
    label = pkg.sym.var("label")
    feat = pkg.sym.Convolution(data, num_filter=9, kernel=(3, 3),
                               pad=(1, 1), name="conv")
    box = pkg.sym.Convolution(data, num_filter=12, kernel=(3, 3),
                              pad=(1, 1), name="box")
    anchors = pkg.sym.contrib.MultiBoxPrior(feat, sizes=(.3, .5),
                                            ratios=(1, 2), name="prior")
    cls = pkg.sym.softmax(pkg.sym.reshape(feat, shape=(0, 3, -1)), axis=1)
    loc = pkg.sym.reshape(box * 0.1, shape=(0, -1))
    target = pkg.sym.contrib.MultiBoxTarget(anchors, label, cls,
                                            negative_mining_ratio=3.0,
                                            name="target")
    det = pkg.sym.contrib.MultiBoxDetection(cls, loc, anchors,
                                            nms_threshold=0.45,
                                            name="det")
    return pkg.sym.Group([anchors, target[0], target[1], target[2], det])


def test_multibox_symbols_through_module():
    """The detection ops as `sym.contrib` symbols, bound by Module and run
    forward, equal the port's imperative ops and the reference's Module."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 3, 4, 4).astype(np.float32)
    w = (rng.randn(9, 3, 3, 3) * .3).astype(np.float32)
    b = np.zeros(9, np.float32)
    wb = (rng.randn(12, 3, 3, 3) * .3).astype(np.float32)
    bb = np.zeros(12, np.float32)
    label = np.full((2, 3, 5), -1, np.float32)
    label[:, :2, 0] = [[0, 1], [1, 1]]
    label[:, :2, 1:] = _boxes(rng, (2, 2))
    outs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            mod = pkg.mod.Module(_ssd_graph(pkg), data_names=["data",
                                                              "label"],
                                 label_names=None, context=pkg.cpu())
            mod.bind(data_shapes=[("data", x.shape), ("label", label.shape)],
                     for_training=False)
            mod.init_params(arg_params={"conv_weight": pkg.nd.array(w),
                                        "conv_bias": pkg.nd.array(b),
                                        "box_weight": pkg.nd.array(wb),
                                        "box_bias": pkg.nd.array(bb)})
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x),
                                          pkg.nd.array(label)], None),
                        is_train=False)
            outs.append([o.asnumpy() for o in mod.get_outputs()])
    want, got = outs
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[0], want[0])
    _close(got[1], want[1], EXP_LOG_TOL, "box_target")
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    # the class scores come out of each package's softmax (one ulp apart)
    np.testing.assert_array_equal(got[4][..., 0], want[4][..., 0])
    _close(got[4][..., 1:], want[4][..., 1:], EXP_LOG_TOL, "detections")
    with mx.cpu():
        feat = mx.nd.Convolution(mx.nd.array(x), mx.nd.array(w),
                                 mx.nd.array(b), num_filter=9,
                                 kernel=(3, 3), pad=(1, 1))
        anchors = mx.nd.contrib.MultiBoxPrior(feat, sizes=(.3, .5),
                                              ratios=(1, 2))
    np.testing.assert_array_equal(got[0], anchors.asnumpy())
