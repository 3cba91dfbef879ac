"""paddle_tpu_torch.vision (counterpart of ``paddle_tpu/vision``): the
models (LeNet, ResNet, VGG, the MobileNets), the datasets, the
transforms (host-side numpy), ``ops`` (deformable convolution, the
YOLOv3 ops, image io) and ``detection`` (priors, box maths, matching,
NMS, the SSD loss and head, the two-stage family), with ``mask_labels``
(host-side Mask R-CNN targets).  Detection keeps the reference's
fixed-shape outputs: padded rows with label -1, counts as tensors."""
from . import datasets, detection, models, ops, transforms
from .datasets import MNIST, FashionMNIST, Cifar10, Cifar100, Flowers
from .models import *  # noqa: F401,F403


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"
