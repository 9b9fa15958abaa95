"""ResNet v1/v2 (the port of `mxnet_tpu.gluon.model_zoo.vision.resnet`):
the same architectures (resnet18..152, v1 and v2), block and parameter
names, and `get_resnet` entry points. `resnet50_v1(layout="NHWC")` with
MXNET_TPU_FUSED_CONVBN=1 runs its 16 bottleneck 3x3 convs through the fused
conv-BN-ReLU kernel on a card."""
from __future__ import annotations

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]

from ....base import get_env
from ...block import HybridBlock
from ... import nn


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _bn_axis(layout):
    return 1 if layout == "NCHW" else -1


def _use_fused_convbn(layout, stride, in_channels):
    """MXNET_TPU_FUSED_CONVBN=1 (read through the port's env registry)
    swaps interior conv3x3+BN+ReLU triples for
    gluon.contrib.cnn.FusedConvBNReLUTrain (NHWC, stride 1, known
    in_channels only). It chooses the architecture, not a kernel: the fused
    block's parameter names differ from the composed triple's, so
    checkpoints are not interchangeable across the gate."""
    return (get_env("MXNET_TPU_FUSED_CONVBN") and layout == "NHWC"
            and stride == 1 and in_channels > 0)


def _add_conv3x3_bn_relu(body, channels, stride, in_channels, layout):
    """conv3x3 -> BN -> relu, fused when the gate + shape allow."""
    if _use_fused_convbn(layout, stride, in_channels):
        from ...contrib.cnn import FusedConvBNReLUTrain
        body.add(FusedConvBNReLUTrain(channels, in_channels=in_channels))
    else:
        body.add(_conv3x3(channels, stride, in_channels, layout))
        body.add(nn.BatchNorm(axis=_bn_axis(layout)))
        body.add(nn.Activation("relu"))


class BasicBlockV1(HybridBlock):

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        x = F.Activation(residual + x, act_type="relu")
        return x


class BottleneckV1(HybridBlock):

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        _add_conv3x3_bn_relu(self.body, channels // 4, 1, channels // 4,
                             layout)
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        x = F.Activation(x + residual, act_type="relu")
        return x


class BasicBlockV2(HybridBlock):

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=_bn_axis(layout)))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i], layout=layout))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW"):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


class ResNetV2(HybridBlock):

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           axis=ax))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=ax))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels, layout=layout))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW"):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None,
               root="~/.mxnet/models", **kwargs):
    """A ResNet by version (1, 2) and depth (18, 34, 50, 101, 152)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    block_type, layers, channels = resnet_spec[num_layers]
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    if pretrained:
        raise ValueError(
            "pretrained weights are not downloaded; load parameters with "
            "load_parameters()")
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
