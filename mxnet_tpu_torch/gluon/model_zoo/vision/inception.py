"""Inception v3 (the port of `mxnet_tpu.gluon.model_zoo.vision.inception`):
the same mixed blocks A-E and parameter names, for 299x299 inputs (the
closing 8x8 average pool). Blocks A-D are `HybridConcurrent`s of branches
concatenated on the channels; E concatenates nested pairs of branches."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    """An optional pool ("avg": 3x3 stride 1 pad 1; "max": 3x3 stride 2),
    then a basic conv for each (channels, kernel_size, strides, padding)
    setting, None meaning the default."""
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {setting_names[i]: value
                  for i, value in enumerate(setting) if value is not None}
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    out = nn.HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = nn.HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = nn.HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = nn.HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _MixedE(HybridBlock):
    """Block E: a 1x1 branch, two branches that each split into a 1x3 and
    a 3x1 conv concatenated, and a pooled branch, all concatenated."""

    def __init__(self, prefix=None, **kwargs):
        super().__init__(prefix=prefix, **kwargs)
        with self.name_scope():
            self.branch1 = _make_branch(None, (320, 1, None, None))
            self.branch2_stem = _make_basic_conv(channels=384, kernel_size=1)
            self.branch2_a = _make_basic_conv(
                channels=384, kernel_size=(1, 3), padding=(0, 1))
            self.branch2_b = _make_basic_conv(
                channels=384, kernel_size=(3, 1), padding=(1, 0))
            self.branch3_stem = _make_branch(None, (448, 1, None, None),
                                             (384, 3, None, 1))
            self.branch3_a = _make_basic_conv(
                channels=384, kernel_size=(1, 3), padding=(0, 1))
            self.branch3_b = _make_basic_conv(
                channels=384, kernel_size=(3, 1), padding=(1, 0))
            self.branch_pool = _make_branch("avg", (192, 1, None, None))

    def hybrid_forward(self, F, x):
        s2 = self.branch2_stem(x)
        s3 = self.branch3_stem(x)
        return F.concat(
            self.branch1(x),
            F.concat(self.branch2_a(s2), self.branch2_b(s2), dim=1),
            F.concat(self.branch3_a(s3), self.branch3_b(s3), dim=1),
            self.branch_pool(x), dim=1)


def _make_E(prefix):
    return _MixedE(prefix=prefix)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load "
                         "parameters with load_parameters()")
    return net
