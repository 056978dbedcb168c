"""Vision models of the port: the ResNet family and the Vision
Transformer (the other model-zoo nets wait for ROADMAP A13's rest)."""

from .resnet import (  # noqa: F401
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext50_64x4d,
    resnext101_32x4d,
    resnext101_64x4d,
    resnext152_32x4d,
    resnext152_64x4d,
    wide_resnet50_2,
    wide_resnet101_2,
)
from .vit import (  # noqa: F401
    PatchEmbed,
    VisionTransformer,
    ViTBlock,
    vit_base_patch16_224,
    vit_large_patch16_224,
)
