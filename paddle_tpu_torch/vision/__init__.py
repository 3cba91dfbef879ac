"""paddle_tpu_torch.vision (counterpart of ``paddle_tpu/vision``):
``models`` (LeNet, ResNet) and ``datasets`` (the synthetic MNIST).
Transforms, ops, detection and the other models and datasets are not
ported (ROADMAP Queue 1 item 4)."""
from . import datasets, models
from .datasets import MNIST, FashionMNIST
from .models import (BasicBlock, BottleneckBlock, LeNet, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
