"""paddle_tpu_torch.vision.datasets: MNIST / FashionMNIST, Cifar10 /
Cifar100, Flowers, VOC2012 and the folder datasets (each module a copy of
its ``paddle_tpu/vision/datasets`` counterpart, code unchanged; none
downloads anything)."""
from .mnist import MNIST, FashionMNIST
from .cifar import Cifar10, Cifar100
from .flowers import Flowers
from .folder import DatasetFolder, ImageFolder
from .voc2012 import VOC2012
