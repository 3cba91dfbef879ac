"""paddle_tpu_torch.vision.models: LeNet, the ResNet family, VGG and the
MobileNets (counterparts of ``paddle_tpu/vision/models``)."""
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
