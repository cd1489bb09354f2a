"""Vision models of the port (``paddle_tpu.vision.models``)."""

from .lenet import LeNet  # noqa: F401
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152)
from .vit import ViTConfig, VisionTransformer, vit_b_16, vit_l_16  # noqa: F401
from .zoo import (VGG, AlexNet, MobileNetV1, MobileNetV2,  # noqa: F401
                  SqueezeNet, alexnet, mobilenet_v1, mobilenet_v2,
                  squeezenet1_0, squeezenet1_1, vgg11, vgg13, vgg16, vgg19)
