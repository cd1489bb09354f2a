"""ResNet — port of ``paddle_tpu/vision/models/resnet.py``: the ImageNet
stem (7 x 7 stride-2 conv, 3 x 3 stride-2 max pool) at every input size,
CIFAR's 32 x 32 included, as in the JAX package."""

from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...nn.functional import flatten
from ...nn.initializer import seeded


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError("no pretrained weights ship with the port: build "
                         "the model and load a state dict "
                         "(paddle_tpu_torch.weights.load_jax_state)")


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        kw = dict(device=device, generator=generator)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **kw)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(tnn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        kw = dict(device=device, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(tnn.Module):
    """On ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``), weights drawn from a generator seeded by ``seed``."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, seed=0):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        dev, gen = seeded(device, seed)
        kw = dict(device=dev, generator=gen)
        self.groups, self.base_width = groups, width
        self.num_classes, self.with_pool = num_classes, with_pool
        self.inplanes, self.dilation = 64, 1
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(self.inplanes, device=dev)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, kw)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride, kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **kw),
                nn.BatchNorm2D(planes * block.expansion,
                               device=kw["device"]))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
