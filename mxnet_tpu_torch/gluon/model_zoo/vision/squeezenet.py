"""SqueezeNet 1.0 and 1.1 (the port of
`mxnet_tpu.gluon.model_zoo.vision.squeezenet`). Its max pools round up
(`ceil_mode=True`, the op's "full" convention), which leaves the 13x13
map that the fixed 13x13 average pool of the head expects at 224x224."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    """The fire module: a 1x1 squeeze, then 1x1 and 3x3 expansions
    concatenated on the channels."""
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = nn.HybridConcurrent(axis=1, prefix="")
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise ValueError("Unsupported SqueezeNet version %s: 1.0 or 1.1 "
                             "expected" % version)

        def pool():
            return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(pool())
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(pool())
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(pool())
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(pool())
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(pool())
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(pool())
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.AvgPool2D(13))
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load "
                         "parameters with load_parameters()")
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
