"""VGG: the port of ``paddle_tpu/vision/models/vgg.py`` (PaddleClas's
VGG-16 is a one-card image-classification configuration).

3x3 convolutions (with ``BatchNorm2D`` when ``batch_norm``) and ReLU in
the JAX configurations A, B, D and E (VGG-11, 13, 16, 19), 2x2 max pools,
a 7x7 adaptive average pool and three ``Linear`` layers with dropout,
registered in the JAX order.  ``pretrained`` is accepted and ignored, as
the JAX constructors ignore it: the weights are random, drawn on
``device`` (the card unless ``device="cpu"``) in ``dtype`` from
``generator``.
"""

from __future__ import annotations

from torch import nn

from ...device import resolve_device
from ...nn.activation import ReLU
from ...nn.common import Dropout, Linear
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D, MaxPool2D

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False, device=None, dtype=None,
                 generator=None):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(Conv2D(in_channels, v, kernel_size=3, padding=1,
                                 device=device, dtype=dtype,
                                 generator=generator))
            if batch_norm:
                layers.append(BatchNorm2D(v, device=device, dtype=dtype))
            layers.append(ReLU())
            in_channels = v
    return Sequential(*layers)


class VGG(nn.Module):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, device=None, dtype=None, generator=None, **kwargs):
    device = resolve_device(device)
    return VGG(_make_layers(_CFGS[cfg], batch_norm, device, dtype, generator),
               device=device, dtype=dtype, generator=generator, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
