"""paddle_tpu_torch.vision.transforms: the nineteen transform classes and
their functionals, host-side numpy on HWC arrays (copies of
``paddle_tpu/vision/transforms``, code unchanged: the random transforms
draw from Python's ``random`` in the reference's order, so
``random.seed(s)`` gives the same crops, flips and jitter)."""
from .transforms import (Compose, Resize, Normalize, ToTensor, Transpose,
                         RandomCrop, CenterCrop, RandomHorizontalFlip,
                         RandomVerticalFlip, RandomResizedCrop, Pad,
                         BrightnessTransform, ContrastTransform,
                         SaturationTransform, HueTransform, ColorJitter,
                         Grayscale, RandomRotation, BaseTransform)
from . import functional
