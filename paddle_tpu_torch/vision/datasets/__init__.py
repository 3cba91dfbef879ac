"""paddle_tpu_torch.vision.datasets: the synthetic ``MNIST`` and
``FashionMNIST`` (a copy of ``paddle_tpu/vision/datasets/mnist.py``); the
reference's other datasets are not ported."""
from .mnist import MNIST, FashionMNIST
