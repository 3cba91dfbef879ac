# Copied from paddle_tpu/vision/datasets/folder.py (the folder datasets, a .npy loader with PIL for other files), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""DatasetFolder/ImageFolder (ref: python/paddle/vision/datasets/folder.py).

Loads .npy/.png-style image trees; in this environment images are read with
numpy (PIL-free loader for .npy; uint8 raw for simple formats).
"""
from __future__ import annotations

import os

import numpy as np

from ...io.dataset import Dataset

IMG_EXTENSIONS = (".npy", ".png", ".jpg", ".jpeg", ".bmp")


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        raise RuntimeError(f"cannot load {path}: install pillow or use .npy")


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                path = os.path.join(cdir, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append((path, self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, files in os.walk(root):
            for fname in sorted(files):
                if fname.lower().endswith(tuple(extensions)):
                    self.samples.append(os.path.join(dirpath, fname))

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return (img,)

    def __len__(self):
        return len(self.samples)
