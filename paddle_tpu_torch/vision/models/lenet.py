"""LeNet: the port of ``paddle_tpu/vision/models/lenet.py`` (the MNIST
rung of the image-classification ladder).

Two 3x3 / 5x5 convolutions with ReLU and 2x2 max pools, then three
``Linear`` layers without activations between them, as the JAX model;
sub-layers registered in the JAX order.  The weights are random, drawn on
``device`` (the card unless ``device="cpu"``) in ``dtype`` from
``generator``; ``convert.lenet_from_paddle_tpu`` loads the JAX model's.
"""

from __future__ import annotations

from torch import nn

from ...device import resolve_device
from ...nn.activation import ReLU
from ...nn.common import Linear
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.pooling import MaxPool2D


class LeNet(nn.Module):
    def __init__(self, num_classes=10, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, **kw),
                Linear(120, 84, **kw),
                Linear(84, num_classes, **kw),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x
