"""LeNet — port of ``paddle_tpu/vision/models/lenet.py``."""

from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...nn.functional import flatten
from ...nn.initializer import seeded


class LeNet(tnn.Module):
    """On ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``), weights drawn from a generator seeded by ``seed``;
    1 x 28 x 28 inputs."""

    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        dev, gen = seeded(device, seed)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(nn.Linear(400, 120, **kw),
                                    nn.Linear(120, 84, **kw),
                                    nn.Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
