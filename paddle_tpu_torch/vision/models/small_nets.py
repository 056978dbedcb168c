"""The compact CNNs of the model zoo: the port of
``paddle_tpu/vision/models/small_nets.py`` (MobileNetV1/V3, AlexNet,
SqueezeNet, DenseNet, GoogLeNet, InceptionV3, ShuffleNetV2).

Each net keeps the JAX package's topology, channel rounding (MobileNetV1's
``max(int(ch * scale), 8)``, MobileNetV3's ``max(int(ch * scale + 4) // 8
* 8, 8)``) and sub-layer names, registered in the JAX order, so that
``convert.paddle_parameter_order`` gives the JAX parameter list and
``convert.load_paddle_tpu_state`` loads the JAX ``state_dict``.  As in the
JAX package, ``GoogLeNet`` returns ``(out, aux1, aux2)`` in both modes and
InceptionV3 is its compact grouped-inception form.  ``pretrained`` is
accepted and ignored; the weights are random, drawn on ``device`` (the
card unless ``device="cpu"``) in ``dtype`` from ``generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn.activation import Hardsigmoid, Hardswish, ReLU
from ...nn.common import Dropout, Flatten, Linear
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D


def _kw(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


def _conv_bn(in_c, out_c, k=3, stride=1, padding=None, groups=1, act="relu",
             kw=None):
    kw = kw or {}
    padding = (k - 1) // 2 if padding is None else padding
    layers = [Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, **kw),
              BatchNorm2D(out_c, device=kw.get("device"),
                          dtype=kw.get("dtype"))]
    if act == "relu":
        layers.append(ReLU())
    elif act == "hardswish":
        layers.append(Hardswish())
    return Sequential(*layers)


# --- MobileNetV1 --------------------------------------------------------------

class MobileNetV1(nn.Module):
    """The depthwise-separable stack."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        feats = [_conv_bn(3, c(32), stride=2, kw=kw)]
        for in_c, out_c, s in cfg:
            feats.append(_conv_bn(c(in_c), c(in_c), stride=s,
                                  groups=c(in_c), kw=kw))      # depthwise
            feats.append(_conv_bn(c(in_c), c(out_c), k=1, kw=kw))
        self.features = Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


# --- MobileNetV3 --------------------------------------------------------------

class _SE(nn.Module):
    def __init__(self, ch, r=4, kw=None):
        super().__init__()
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.fc1 = Conv2D(ch, ch // r, 1, **kw)
        self.fc2 = Conv2D(ch // r, ch, 1, **kw)
        self.relu = ReLU()
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _MBV3Block(nn.Module):
    def __init__(self, in_c, exp, out_c, k, stride, se, act, kw):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp != in_c:
            layers.append(_conv_bn(in_c, exp, k=1, act=act, kw=kw))
        layers.append(_conv_bn(exp, exp, k=k, stride=stride, groups=exp,
                               act=act, kw=kw))
        if se:
            layers.append(_SE(exp, kw=kw))
        layers.append(_conv_bn(exp, out_c, k=1, act="none", kw=kw))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_MBV3_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_MBV3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(nn.Module):
    def __init__(self, cfg, last_exp, last_ch, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, dtype=None, generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale + 4) // 8 * 8, 8)

        blocks = [_conv_bn(3, c(16), stride=2, act="hardswish", kw=kw)]
        in_c = c(16)
        for k, exp, out, se, act, s in cfg:
            blocks.append(_MBV3Block(in_c, c(exp), c(out), k, s, se, act, kw))
            in_c = c(out)
        blocks.append(_conv_bn(in_c, c(last_exp), k=1, act="hardswish",
                               kw=kw))
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(c(last_exp), last_ch, **kw), Hardswish(),
                Dropout(0.2), Linear(last_ch, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_MBV3_LARGE, 960, 1280, scale, num_classes,
                         with_pool, **kwargs)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_MBV3_SMALL, 576, 1024, scale, num_classes,
                         with_pool, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


# --- AlexNet ------------------------------------------------------------------

class AlexNet(nn.Module):
    def __init__(self, num_classes=1000, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1, **kw), ReLU(),
            Conv2D(384, 256, 3, padding=1, **kw), ReLU(),
            Conv2D(256, 256, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, stride=2))
        self.pool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Linear(256 * 36, 4096, **kw), ReLU(),
                Dropout(0.5), Linear(4096, 4096, **kw), ReLU(),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.pool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


# --- SqueezeNet ---------------------------------------------------------------

class _Fire(nn.Module):
    def __init__(self, in_c, squeeze, e1, e3, kw):
        super().__init__()
        self.squeeze = Sequential(Conv2D(in_c, squeeze, 1, **kw), ReLU())
        self.e1 = Sequential(Conv2D(squeeze, e1, 1, **kw), ReLU())
        self.e3 = Sequential(Conv2D(squeeze, e3, 3, padding=1, **kw), ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.e1(s), self.e3(s)], dim=1)


class SqueezeNet(nn.Module):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64, kw), _Fire(128, 16, 64, 64, kw),
                _Fire(128, 32, 128, 128, kw), MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128, kw), _Fire(256, 48, 192, 192, kw),
                _Fire(384, 48, 192, 192, kw), _Fire(384, 64, 256, 256, kw),
                MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256, kw))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64, kw), _Fire(128, 16, 64, 64, kw),
                MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128, kw), _Fire(256, 32, 128, 128, kw),
                MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192, kw), _Fire(384, 48, 192, 192, kw),
                _Fire(384, 64, 256, 256, kw), _Fire(512, 64, 256, 256, kw))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Conv2D(512, num_classes, 1, **kw), ReLU())
        self.pool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet("1.1", **kwargs)


# --- DenseNet -----------------------------------------------------------------

class _DenseLayer(nn.Module):
    def __init__(self, in_c, growth, bn_size, kw):
        super().__init__()
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.bn1 = BatchNorm2D(in_c, **nkw)
        self.conv1 = Conv2D(in_c, bn_size * growth, 1, bias_attr=False, **kw)
        self.bn2 = BatchNorm2D(bn_size * growth, **nkw)
        self.conv2 = Conv2D(bn_size * growth, growth, 3, padding=1,
                            bias_attr=False, **kw)
        self.relu = ReLU()

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        return torch.cat([x, out], dim=1)


_DENSE_CFG = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
              169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
              264: (6, 12, 64, 48)}


class DenseNet(nn.Module):
    def __init__(self, layers=121, growth_rate=32, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        nkw = dict(device=kw["device"], dtype=dtype)
        if layers == 161:
            growth_rate, init_c = 48, 96
        else:
            init_c = 64
        self.num_classes = num_classes
        self.with_pool = with_pool
        blocks = [Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False,
                         **kw),
                  BatchNorm2D(init_c, **nkw), ReLU(),
                  MaxPool2D(3, stride=2, padding=1)]
        ch = init_c
        cfg = _DENSE_CFG[layers]
        for bi, n in enumerate(cfg):
            for _ in range(n):
                blocks.append(_DenseLayer(ch, growth_rate, bn_size, kw))
                ch += growth_rate
            if bi != len(cfg) - 1:  # a transition halves channels and space
                blocks += [BatchNorm2D(ch, **nkw), ReLU(),
                           Conv2D(ch, ch // 2, 1, bias_attr=False, **kw),
                           AvgPool2D(2, stride=2)]
                ch //= 2
        blocks += [BatchNorm2D(ch, **nkw), ReLU()]
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(ch, num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def densenet121(pretrained=False, **kwargs):
    return DenseNet(121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return DenseNet(161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return DenseNet(169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return DenseNet(201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return DenseNet(264, **kwargs)


# --- GoogLeNet ----------------------------------------------------------------

class _Inception(nn.Module):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj, kw):
        super().__init__()
        self.b1 = Sequential(Conv2D(in_c, c1, 1, **kw), ReLU())
        self.b2 = Sequential(Conv2D(in_c, c3r, 1, **kw), ReLU(),
                             Conv2D(c3r, c3, 3, padding=1, **kw), ReLU())
        self.b3 = Sequential(Conv2D(in_c, c5r, 1, **kw), ReLU(),
                             Conv2D(c5r, c5, 5, padding=2, **kw), ReLU())
        self.b4 = Sequential(MaxPool2D(3, stride=1, padding=1),
                             Conv2D(in_c, proj, 1, **kw), ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         dim=1)


class GoogLeNet(nn.Module):
    """Returns ``(out, aux1, aux2)`` when it has a head, as the JAX model."""

    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            Conv2D(3, 64, 7, stride=2, padding=3, **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1),
            Conv2D(64, 64, 1, **kw), ReLU(),
            Conv2D(64, 192, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32, kw)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64, kw)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64, kw)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64, kw)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64, kw)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64, kw)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128, kw)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128, kw)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128, kw)
        self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(1024, num_classes, **kw)
            self.aux1 = Sequential(
                AdaptiveAvgPool2D((4, 4)), Flatten(),
                Linear(512 * 16, 1024, **kw), ReLU(),
                Linear(1024, num_classes, **kw))
            self.aux2 = Sequential(
                AdaptiveAvgPool2D((4, 4)), Flatten(),
                Linear(528 * 16, 1024, **kw), ReLU(),
                Linear(1024, num_classes, **kw))

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        a1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        x = self.pool(x).flatten(1)
        if self.num_classes > 0:
            return self.fc(x), a1, a2
        return x


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)


# --- InceptionV3 --------------------------------------------------------------

class InceptionV3(nn.Module):
    """The stem and the A/B/C tower stacks as grouped inceptions, as the JAX
    package's compact form."""

    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _conv_bn(3, 32, 3, stride=2, padding=0, kw=kw),
            _conv_bn(32, 32, 3, padding=0, kw=kw),
            _conv_bn(32, 64, 3, kw=kw),
            MaxPool2D(3, stride=2),
            _conv_bn(64, 80, 1, padding=0, kw=kw),
            _conv_bn(80, 192, 3, padding=0, kw=kw),
            MaxPool2D(3, stride=2))
        self.a1 = _Inception(192, 64, 48, 64, 64, 96, 32, kw)
        self.a2 = _Inception(256, 64, 48, 64, 64, 96, 64, kw)
        self.a3 = _Inception(288, 64, 48, 64, 64, 96, 64, kw)
        self.red1 = Sequential(_conv_bn(288, 384, 3, stride=2, padding=0,
                                        kw=kw))
        self.b1 = _Inception(384, 192, 128, 192, 128, 192, 192, kw)
        self.b2 = _Inception(768, 192, 160, 192, 160, 192, 192, kw)
        self.red2 = Sequential(_conv_bn(768, 1280, 3, stride=2, padding=0,
                                        kw=kw))
        self.c1 = _Inception(1280, 320, 384, 384, 448, 384, 192, kw)
        self.c2 = _Inception(1280, 320, 384, 384, 448, 384, 192, kw)
        self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(1280, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        x = self.a3(self.a2(self.a1(x)))
        x = self.red1(x)
        x = self.b2(self.b1(x))
        x = self.red2(x)
        x = self.c2(self.c1(x))
        x = self.pool(x).flatten(1)
        if self.num_classes > 0:
            x = self.fc(x)
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)


# --- ShuffleNetV2 -------------------------------------------------------------

def _channel_shuffle(x, groups):
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2) \
        .reshape(B, C, H, W)


class _ShuffleUnit(nn.Module):
    def __init__(self, in_c, out_c, stride, act, kw):
        super().__init__()
        self.stride = stride
        branch = out_c // 2
        if stride == 1:
            self.right = Sequential(
                _conv_bn(branch, branch, 1, act=act, kw=kw),
                _conv_bn(branch, branch, 3, groups=branch, act="none",
                         kw=kw),
                _conv_bn(branch, branch, 1, act=act, kw=kw))
        else:
            self.left = Sequential(
                _conv_bn(in_c, in_c, 3, stride=2, groups=in_c, act="none",
                         kw=kw),
                _conv_bn(in_c, branch, 1, act=act, kw=kw))
            self.right = Sequential(
                _conv_bn(in_c, branch, 1, act=act, kw=kw),
                _conv_bn(branch, branch, 3, stride=2, groups=branch,
                         act="none", kw=kw),
                _conv_bn(branch, branch, 1, act=act, kw=kw))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = torch.cat([x[:, :c], self.right(x[:, c:])], dim=1)
        else:
            out = torch.cat([self.left(x), self.right(x)], dim=1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CH = {
    0.25: (24, 24, 48, 96, 512), 0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024), 1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024), 2.0: (24, 244, 488, 976, 2048),
}


class ShuffleNetV2(nn.Module):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None, dtype=None, generator=None):
        super().__init__()
        kw = _kw(resolve_device(device), dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        c0, c1, c2, c3, c_last = _SHUFFLE_CH[scale]
        self.stem = Sequential(_conv_bn(3, c0, 3, stride=2, act=act, kw=kw),
                               MaxPool2D(3, stride=2, padding=1))
        stages = []
        in_c = c0
        for out_c, repeat in ((c1, 4), (c2, 8), (c3, 4)):
            stages.append(_ShuffleUnit(in_c, out_c, 2, act, kw))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(out_c, out_c, 1, act, kw))
            in_c = out_c
        self.stages = Sequential(*stages)
        self.last = _conv_bn(in_c, c_last, 1, act=act, kw=kw)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(c_last, num_classes, **kw)

    def forward(self, x):
        x = self.last(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shuffle(scale, act="relu", **kw):
    return ShuffleNetV2(scale=scale, act=act, **kw)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _shuffle(0.25, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _shuffle(0.33, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _shuffle(0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _shuffle(1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _shuffle(1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _shuffle(2.0, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _shuffle(1.0, act="hardswish", **kw)
