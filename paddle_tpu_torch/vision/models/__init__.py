"""Vision models of the port: the JAX package's model zoo (LeNet, the
ResNet family, VGG, MobileNetV1/V2/V3, AlexNet, SqueezeNet, DenseNet,
GoogLeNet, InceptionV3, ShuffleNetV2 and the Vision Transformer)."""

from .lenet import LeNet  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
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
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .small_nets import (  # noqa: F401
    AlexNet,
    DenseNet,
    GoogLeNet,
    InceptionV3,
    MobileNetV1,
    MobileNetV3Large,
    MobileNetV3Small,
    ShuffleNetV2,
    SqueezeNet,
    alexnet,
    densenet121,
    densenet161,
    densenet169,
    densenet201,
    densenet264,
    googlenet,
    inception_v3,
    mobilenet_v1,
    mobilenet_v3_large,
    mobilenet_v3_small,
    shufflenet_v2_swish,
    shufflenet_v2_x0_25,
    shufflenet_v2_x0_33,
    shufflenet_v2_x0_5,
    shufflenet_v2_x1_0,
    shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
    squeezenet1_0,
    squeezenet1_1,
)
