"""The CNN zoo — port of ``paddle_tpu/vision/models/zoo.py``: VGG,
MobileNetV1/V2, AlexNet and SqueezeNet over the port's conv, norm and
pool layers.

Each model is built on ``device`` (default: the CUDA device; raises
without one unless ``device="cpu"``) with weights drawn from a generator
seeded by ``seed``; its ``Dropout`` layers draw their masks from a second
generator seeded alike (``dropout_generator``). A VGG built by a factory
draws its features from ``seed`` and its classifier from ``seed + 1``
(``VGG`` itself takes the features ready made).
"""

from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...nn.functional import flatten
from ...nn.initializer import seeded
from .resnet import _no_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1",
           "mobilenet_v1", "MobileNetV2", "mobilenet_v2", "AlexNet",
           "alexnet", "SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _sources(module, device, seed):
    """The init keywords for ``module``'s layers; sets its
    ``dropout_generator``."""
    dev, gen = seeded(device, seed)
    module.dropout_generator = seeded(dev, seed)[1]
    return dict(device=dev, generator=gen)


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(tnn.Module):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        kw = _sources(self, device, seed)
        drop = self.dropout_generator
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D([7, 7])
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(),
                nn.Dropout(generator=drop),
                nn.Linear(4096, 4096, **kw), nn.ReLU(),
                nn.Dropout(generator=drop),
                nn.Linear(4096, num_classes, **kw))
        self.num_classes = num_classes

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg_features(cfg, batch_norm, device, generator):
    layers, cin = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(cin, v, 3, padding=1, device=device,
                                    generator=generator))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=device))
            layers.append(nn.ReLU())
            cin = v
    return nn.Sequential(*layers)


def _vgg(cfg_key, pretrained, batch_norm, device=None, seed=0, **kwargs):
    _no_pretrained(pretrained)
    dev, gen = seeded(device, seed)
    features = _vgg_features(_VGG_CFGS[cfg_key], batch_norm, dev, gen)
    return VGG(features, device=dev, seed=seed + 1, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, **kwargs)


# ---------------------------------------------------------------------------
# MobileNet v1/v2
# ---------------------------------------------------------------------------

def _conv_bn(cin, cout, k, stride, padding, groups, kw):
    return nn.Sequential(
        nn.Conv2D(cin, cout, k, stride=stride, padding=padding,
                  groups=groups, bias_attr=False, **kw),
        nn.BatchNorm2D(cout, device=kw["device"]), nn.ReLU6())


class MobileNetV1(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        kw = _sources(self, device, seed)

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + [
              (512, 1024, 2), (1024, 1024, 1)]
        layers = [_conv_bn(3, c(32), 3, 2, 1, 1, kw)]
        for cin, cout, s in cfg:
            layers.append(_conv_bn(c(cin), c(cin), 3, s, 1, c(cin), kw))
            layers.append(_conv_bn(c(cin), c(cout), 1, 1, 0, 1, kw))
        self.features = nn.Sequential(*layers)
        self.with_pool, self.num_classes = with_pool, num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


class _InvertedResidual(tnn.Module):
    def __init__(self, cin, cout, stride, expand, kw):
        super().__init__()
        hidden = int(round(cin * expand))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand != 1:
            layers.append(_conv_bn(cin, hidden, 1, 1, 0, 1, kw))
        layers += [
            _conv_bn(hidden, hidden, 3, stride, 1, hidden, kw),
            nn.Conv2D(hidden, cout, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(cout, device=kw["device"]),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        kw = _sources(self, device, seed)
        cfgs = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

        def c(ch):
            return max(int(ch * scale), 8)

        layers = [_conv_bn(3, c(32), 3, 2, 1, 1, kw)]
        cin = c(32)
        for t, ch, n, s in cfgs:
            for i in range(n):
                layers.append(_InvertedResidual(cin, c(ch),
                                                s if i == 0 else 1, t, kw))
                cin = c(ch)
        self.last_ch = c(1280) if scale > 1.0 else 1280
        layers.append(_conv_bn(cin, self.last_ch, 1, 1, 0, 1, kw))
        self.features = nn.Sequential(*layers)
        self.with_pool, self.num_classes = with_pool, num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2, generator=self.dropout_generator),
                nn.Linear(self.last_ch, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


# ---------------------------------------------------------------------------
# AlexNet / SqueezeNet
# ---------------------------------------------------------------------------

class AlexNet(tnn.Module):
    def __init__(self, num_classes=1000, device=None, seed=0):
        super().__init__()
        kw = _sources(self, device, seed)
        drop = self.dropout_generator
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2D([6, 6])
        self.classifier = nn.Sequential(
            nn.Dropout(generator=drop), nn.Linear(256 * 36, 4096, **kw),
            nn.ReLU(), nn.Dropout(generator=drop),
            nn.Linear(4096, 4096, **kw), nn.ReLU(),
            nn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(flatten(x, 1))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


class _Fire(tnn.Module):
    def __init__(self, cin, squeeze, e1, e3, kw):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(cin, squeeze, 1, **kw),
                                     nn.ReLU())
        self.e1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1, **kw), nn.ReLU())
        self.e3 = nn.Sequential(nn.Conv2D(squeeze, e3, 3, padding=1, **kw),
                                nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.e1(s), self.e3(s)], dim=1)


class SqueezeNet(tnn.Module):
    def __init__(self, version="1.0", num_classes=1000, device=None, seed=0):
        super().__init__()
        kw = _sources(self, device, seed)
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64, kw), _Fire(128, 16, 64, 64, kw),
                _Fire(128, 32, 128, 128, kw), nn.MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128, kw), _Fire(256, 48, 192, 192, kw),
                _Fire(384, 48, 192, 192, kw), _Fire(384, 64, 256, 256, kw),
                nn.MaxPool2D(3, 2), _Fire(512, 64, 256, 256, kw))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64, kw), _Fire(128, 16, 64, 64, kw),
                nn.MaxPool2D(3, 2), _Fire(128, 32, 128, 128, kw),
                _Fire(256, 32, 128, 128, kw), nn.MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192, kw), _Fire(384, 48, 192, 192, kw),
                _Fire(384, 64, 256, 256, kw), _Fire(512, 64, 256, 256, kw))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5, generator=self.dropout_generator),
            nn.Conv2D(512, num_classes, 1, **kw), nn.ReLU(),
            nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        return flatten(self.classifier(self.features(x)), 1)


def squeezenet1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
