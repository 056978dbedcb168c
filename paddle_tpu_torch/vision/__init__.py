"""``paddle.vision`` of the port: the datasets (synthetic fallbacks, no
downloads), the transforms (numpy, CHW) and the image-classification
models (LeNet, ResNet, ViT; the other model-zoo nets wait for ROADMAP
A13's rest)."""

from . import datasets, models, transforms  # noqa: F401
from .datasets import MNIST, Cifar10, FashionMNIST, Flowers, VOC2012  # noqa: F401
from .models import LeNet  # noqa: F401
