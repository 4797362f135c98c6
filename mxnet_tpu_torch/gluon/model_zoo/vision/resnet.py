"""ResNet v1 and v2.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``
(``BasicBlockV1``, ``BottleneckV1``, ``BasicBlockV2``, ``BottleneckV2``,
``ResNetV1``, ``ResNetV2``, ``resnet_spec``, ``get_resnet`` and
``resnet18_v1`` ... ``resnet152_v2``): the same topology, layer tables and
structural names, so weights carry across by name
(``functional.load_params``). The V1 bodies are ``nn.FusableSequential``,
so in training their conv3x3 + BatchNorm + ReLU triplets take kernel 8
where the ``fused_conv_bn`` knob says so (ResNet-50 v1: the 16
bottlenecks' middle convs). Layers told no input width infer it at the
first forward, as in the reference. Every constructor takes ``device=``
(``cuda:0`` by default); ``pretrained=True`` raises: the port ships no
weight files.
"""
from __future__ import annotations

from ....numpy_extension import tensor_ops as npx
from ....base import MXNetError
from ....context import resolve_device
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet", "resnet_spec"]


def _conv3x3(channels, stride, in_channels, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, device=device)


def _downsample_v1(channels, stride, in_channels, device):
    ds = nn.HybridSequential()
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                     in_channels=in_channels, device=device))
    ds.add(nn.BatchNorm(device=device))
    return ds


class BasicBlockV1(HybridBlock):
    """Reference: resnet.py BasicBlockV1 (conv-bn-relu, conv-bn, residual,
    relu)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.body = nn.FusableSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, device))
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, device))
        self.body.add(nn.BatchNorm(device=device))
        self.downsample = (_downsample_v1(channels, stride, in_channels,
                                          device) if downsample else None)

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return npx.activation(x + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    """Reference: resnet.py BottleneckV1 (1x1 with the stride, 3x3, 1x1)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.body = nn.FusableSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                device=device))
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, device))
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                device=device))
        self.body.add(nn.BatchNorm(device=device))
        self.downsample = (_downsample_v1(channels, stride, in_channels,
                                          device) if downsample else None)

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return npx.activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Reference: resnet.py BasicBlockV2 (pre-activation)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.bn1 = nn.BatchNorm(device=device)
        self.conv1 = _conv3x3(channels, stride, in_channels, device)
        self.bn2 = nn.BatchNorm(device=device)
        self.conv2 = _conv3x3(channels, 1, channels, device)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, device=device)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = npx.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = npx.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    """Reference: resnet.py BottleneckV2 (pre-activation, 1x1-3x3-1x1)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.bn1 = nn.BatchNorm(device=device)
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False,
                               device=device)
        self.bn2 = nn.BatchNorm(device=device)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, device)
        self.bn3 = nn.BatchNorm(device=device)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False, device=device)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, device=device)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = npx.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = npx.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = npx.activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


def _make_layer(block, layers, channels, stride, in_channels, device):
    layer = nn.HybridSequential()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, device=device))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        device=device))
    return layer


def _stem(features, channels, thumbnail, device):
    if thumbnail:
        features.add(_conv3x3(channels, 1, 0, device))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False,
                               device=device))
        features.add(nn.BatchNorm(device=device))
        features.add(nn.Activation("relu"))
        features.add(nn.MaxPool2D(3, 2, 1))


class ResNetV1(HybridBlock):
    """Reference: resnet.py ResNetV1."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} layers need {len(layers) + 1} "
                             f"channel widths, got {len(channels)}")
        device = resolve_device(device)
        self.features = nn.HybridSequential()
        _stem(self.features, channels[0], thumbnail, device)
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, channels[i], device))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1], device=device)

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """Reference: resnet.py ResNetV2 (pre-activation)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} layers need {len(layers) + 1} "
                             f"channel widths, got {len(channels)}")
        device = resolve_device(device)
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False,
                                       device=device))
        _stem(self.features, channels[0], thumbnail, device)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, in_channels, device))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(device=device))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels, device=device)

    def forward(self, x):
        return self.output(self.features(x))


# layer-count table (reference: resnet.py resnet_spec)
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


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` (1 or 2) of depth ``num_layers`` (reference:
    resnet.py get_resnet); ``device=`` and the net's own arguments
    (``classes``, ``thumbnail``) pass through."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    if version not in (1, 2):
        raise MXNetError(f"invalid resnet version {version}")
    if pretrained:
        raise MXNetError("pretrained=True: the port ships no weight files; "
                         "carry weights in with functional.load_params")
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    return resnet_class(block_class, layers, channels, **kwargs)


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
