"""MobileNetV2: the port of ``paddle_tpu/vision/models/mobilenetv2.py``
(PaddleClas's MobileNetV2 is a one-card image-classification
configuration).

Inverted residual blocks (a 1x1 expansion, a depthwise 3x3 and a 1x1
projection, each convolution without bias and followed by
``BatchNorm2D``; ReLU6 after the first two), channels rounded by the JAX
``_make_divisible``, an adaptive average pool and a dropout + ``Linear``
head, registered in the JAX order.  ``pretrained`` is accepted and
ignored; the weights are random, drawn on ``device`` (the card unless
``device="cpu"``) in ``dtype`` from ``generator``.
"""

from __future__ import annotations

from torch import nn

from ...device import resolve_device
from ...nn.activation import ReLU6
from ...nn.common import Dropout, Linear
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1, device=None, dtype=None, generator=None):
        padding = (kernel_size - 1) // 2
        super().__init__(
            Conv2D(in_planes, out_planes, kernel_size, stride, padding,
                   groups=groups, bias_attr=False, device=device,
                   dtype=dtype, generator=generator),
            BatchNorm2D(out_planes, device=device, dtype=dtype),
            ReLU6(),
        )


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1, **kw))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim, **kw),
            Conv2D(hidden_dim, oup, 1, 1, 0, bias_attr=False, **kw),
            BatchNorm2D(oup, device=device, dtype=dtype),
        ])
        self.conv = Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = 32
        last_channel = 1280
        inverted_residual_setting = [
            [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
            [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1],
        ]
        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, **kw)]
        for t, c, n, s in inverted_residual_setting:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                stride = s if i == 0 else 1
                features.append(InvertedResidual(
                    input_channel, output_channel, stride, expand_ratio=t,
                    **kw))
                input_channel = output_channel
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel_size=1, **kw))
        self.features = Sequential(*features)
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), Linear(self.last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
