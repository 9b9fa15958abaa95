"""The detection slice end to end at a small size: an SSD built from public
Gluon blocks (as `examples/ssd_detection.py` builds its TinySSD, here on
the model zoo's ResNetV1 trunk, NHWC, with the fused conv-BN-ReLU gate on)
in both packages with the same seeded weights.

A narrow bottleneck ResNet (channels 8-128, one block a stage) at 64x64 in
fp32 gives two feature maps (the ends of stages 3 and 4) and one extra
layer gives a third: 92 anchors from `MultiBoxPrior`. One training step as
main path 15 takes it: `MultiBoxTarget` with hard-negative mining,
`SoftmaxCrossEntropyLoss` with the keep mask, `HuberLoss` on the masked
boxes, `Trainer("sgd")`; then `MultiBoxDetection`.

Held: the heads within 1e-5; the three MultiBox ops on the same inputs
exact (box targets and decoded boxes within 1e-6: a log and an exp); the
loss within 1e-5; every parameter gradient within 1e-4 (relative L2),
except the trunk's conv biases, which feed a batch-statistics BatchNorm
(zero gradient up to rounding, below 1e-6), and every parameter after the
step within 1e-4. The weights are drawn in the port and cross to the
reference by a `.params` file.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from _torch_seed import _seed_torch  # noqa: F401

TOL = 1e-5
GRAD_REL = 1e-4
IMAGE, BATCH, CLASSES, MAX_BOXES = 64, 4, 3, 4
SIZES = [[.2, .272], [.37, .447], [.54, .619]]
RATIOS = [[1, 2, .5], [1, 2, .5, 3, 1 / 3.], [1, 2, .5]]
EXTRA = [32]


def ssd_net(pkg, base, classes, sizes, ratios, extra, mid_floor):
    """SSD over `base`'s features (NHWC): the ends of its last two stages,
    then one 1x1 + 3x3-stride-2 extra block per entry of `extra`; a 3x3
    class head and box head per map, flattened cell-major and
    concatenated. Returns (cls (B, N, classes + 1), box (B, N * 4))."""
    nn = pkg.gluon.nn
    anchors = [len(s) + len(r) - 1 for s, r in zip(sizes, ratios)]

    class SSD(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.base = base
                self.extras = nn.HybridSequential()
                for f in extra:
                    blk = nn.HybridSequential()
                    blk.add(nn.Conv2D(max(mid_floor, f // 2), 1,
                                      layout="NHWC"),
                            nn.Activation("relu"),
                            nn.Conv2D(f, 3, 2, 1, layout="NHWC"),
                            nn.Activation("relu"))
                    self.extras.add(blk)
                self.cls_heads = nn.HybridSequential()
                self.box_heads = nn.HybridSequential()
                for a in anchors:
                    self.cls_heads.add(nn.Conv2D(a * (classes + 1), 3, 1, 1,
                                                 layout="NHWC"))
                    self.box_heads.add(nn.Conv2D(a * 4, 3, 1, 1,
                                                 layout="NHWC"))

        def hybrid_forward(self, F, x):
            stages = list(self.base.features._children.values())[:-1]
            for blk in stages[:-1]:
                x = blk(x)
            maps = [x, stages[-1](x)]
            for blk in self.extras._children.values():
                maps.append(blk(maps[-1]))
            cls, box = [], []
            for m, ch, bh in zip(maps, self.cls_heads._children.values(),
                                 self.box_heads._children.values()):
                cls.append(F.reshape(ch(m), shape=(0, -1, classes + 1)))
                box.append(F.reshape(bh(m), shape=(0, -1)))
            return F.concat(*cls, dim=1), F.concat(*box, dim=1)

    return SSD(prefix="ssd_")


def _make(pkg, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSED_CONVBN", "1")
    res = pkg.gluon.model_zoo.vision.resnet
    with pkg.name.NameManager():
        base = res.ResNetV1(res.BottleneckV1, [1, 1, 1, 1],
                            [8, 16, 32, 64, 128], classes=10, layout="NHWC")
        return ssd_net(pkg, base, CLASSES, SIZES, RATIOS, EXTRA, 8)


def _data(seed=0):
    """Noise images with bright rectangles; labels [cls, x1, y1, x2, y2]
    padded with -1 rows."""
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32) * 0.2
    y = np.full((BATCH, MAX_BOXES, 5), -1, np.float32)
    for i in range(BATCH):
        for j in range(rng.randint(1, MAX_BOXES + 1)):
            s = rng.randint(12, 40)
            x0, y0 = rng.randint(0, IMAGE - s, 2)
            c = rng.randint(0, CLASSES)
            x[i, y0:y0 + s, x0:x0 + s, c] = 1.0
            y[i, j] = [c, x0 / IMAGE, y0 / IMAGE, (x0 + s) / IMAGE,
                       (y0 + s) / IMAGE]
    return x, y


MAPS = [(4, 4), (2, 2), (1, 1)]     # the three maps' (H, W) at 64x64


def anchors_of(pkg, ctx):
    """MultiBoxPrior over each map's (H, W), given NCHW-shaped."""
    per = [pkg.nd.contrib.MultiBoxPrior(
        pkg.nd.zeros((1, 1) + hw, ctx=ctx), sizes=s, ratios=r, clip=False)
        for hw, s, r in zip(MAPS, SIZES, RATIOS)]
    return pkg.nd.concat(*per, dim=1)


def _random_state(net, seed=1):
    """Seeded weights (fan-in scaled normal), BN gamma/running_var in
    [0.5, 1.5), beta/running_mean/biases N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    for name, p in net._collect_params_with_prefix().items():
        shape = p.shape
        if name.endswith(("gamma", "running_var")):
            a = rng.uniform(.5, 1.5, shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            a = rng.randn(*shape) * .1
        else:
            fan_out = shape[-1] if "fusedconvbnrelutrain" in p.name \
                else shape[0]
            a = rng.randn(*shape) / np.sqrt(np.prod(shape) / fan_out)
        p.set_data(mx.nd.array(a.astype(np.float32), ctx=mx.cpu()))


def _step(pkg, net, anchors, x, y, trainer):
    """One training step; returns (cls, box, box_target, box_mask,
    cls_target, loss, {param: grad})."""
    cls_loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    box_loss = pkg.gluon.loss.HuberLoss()
    with pkg.autograd.record():
        cls, box = net(x)
        prob = pkg.nd.softmax(pkg.nd.transpose(cls, axes=(0, 2, 1)), axis=1)
        bt, bm, ct = pkg.nd.contrib.MultiBoxTarget(
            anchors, y, prob, overlap_threshold=0.5, ignore_label=-1,
            negative_mining_ratio=3, negative_mining_thresh=0.5,
            minimum_negative_samples=0, variances=(0.1, 0.1, 0.2, 0.2))
        keep = (ct >= 0).reshape((BATCH, -1, 1))
        loss = cls_loss(cls, ct, keep).mean() + \
            box_loss(box * bm, bt * bm).mean()
    loss.backward()
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    trainer.step(BATCH)
    return [a.asnumpy() for a in (cls, box, bt, bm, ct, loss)], grads


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def test_ssd_step_matches_reference(monkeypatch, tmp_path):
    x, y = _data()
    with mx.cpu():
        pnet = _make(mx, monkeypatch)
        pnet.initialize(ctx=mx.cpu())
        with mx.autograd.predict_mode():     # resolve the deferred shapes
            feats = pnet(mx.nd.array(x[:1], ctx=mx.cpu()))
        assert feats[0].shape[1] == 92
        _random_state(pnet)
        f = str(tmp_path / "ssd.params")
        pnet.save_parameters(f)
    jnet = _make(jmx, monkeypatch)
    jnet.load_parameters(f, ctx=jmx.cpu())
    for net in (jnet, pnet):
        net.hybridize(static_alloc=True)

    runs = []
    for pkg, net in ((jmx, jnet), (mx, pnet)):
        with pkg.cpu():
            xs, ys = pkg.nd.array(x), pkg.nd.array(y)
            anchors = anchors_of(pkg, pkg.cpu())
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", {
                "learning_rate": 0.002, "momentum": 0.9, "wd": 0.0005})
            outs, grads = _step(pkg, net, anchors, xs, ys, trainer)
            after = {k: p.data().asnumpy()
                     for k, p in net._collect_params_with_prefix().items()}
            runs.append((anchors.asnumpy(), outs, grads, after))
    (ja, jouts, jgrads, jafter), (pa, pouts, pgrads, pafter) = runs

    assert pa.shape == (1, 92, 4)
    np.testing.assert_array_equal(pa, ja)
    _close(pouts[0], jouts[0], TOL, "class head")
    _close(pouts[1], jouts[1], TOL, "box head")
    _close(pouts[5], jouts[5], TOL, "loss")
    assert (jouts[4] > 0).sum() >= BATCH     # every image has a match
    assert sorted(pgrads) == sorted(jgrads)
    for k in jgrads:
        if k.startswith("base.") and k.endswith(".bias"):
            # a trunk conv's bias feeds a batch-statistics BatchNorm: its
            # gradient is zero in exact arithmetic, rounding noise here
            assert np.abs(pgrads[k]).max() < 1e-6, k
            continue
        assert _rel(pgrads[k], jgrads[k]) <= GRAD_REL, (k, _rel(
            pgrads[k], jgrads[k]))
    for k in jafter:
        assert _rel(pafter[k], jafter[k]) <= GRAD_REL, k

    # the three MultiBox ops on the same (the port's) inputs
    prob = np.exp(pouts[0]) / np.exp(pouts[0]).sum(-1, keepdims=True)
    prob = prob.transpose(0, 2, 1).astype(np.float32).copy()
    ops = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            t = pkg.nd.contrib.MultiBoxTarget(
                pkg.nd.array(pa), pkg.nd.array(y), pkg.nd.array(prob),
                overlap_threshold=0.5, ignore_label=-1,
                negative_mining_ratio=3, negative_mining_thresh=0.5)
            d = pkg.nd.contrib.MultiBoxDetection(
                pkg.nd.array(prob), pkg.nd.array(pouts[1]),
                pkg.nd.array(pa), nms_threshold=0.45, nms_topk=40,
                threshold=0.01, force_suppress=False)
            ops.append([a.asnumpy() for a in t] + [d.asnumpy()])
    (jbt, jbm, jct, jdet), (pbt, pbm, pct, pdet) = ops
    _close(pbt, jbt, 1e-6, "box_target")
    np.testing.assert_array_equal(pbm, jbm)
    np.testing.assert_array_equal(pct, jct)
    np.testing.assert_array_equal(pdet[..., :2], jdet[..., :2])
    _close(pdet[..., 2:], jdet[..., 2:], 1e-6, "detections")
    assert (pdet[..., 0] >= 0).sum() > 0
