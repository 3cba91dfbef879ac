"""paddle_tpu_torch.vision.models: ``LeNet`` and the ResNet family
(counterparts of ``paddle_tpu/vision/models/{lenet,resnet}.py``); VGG and
the MobileNets are not ported."""
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)
