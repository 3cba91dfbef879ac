"""Containers (counterpart of ``paddle_tpu/nn/layer/container.py``; only
``Sequential`` and ``LayerList``)."""
from __future__ import annotations

from .layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = layers[0]
        if layers and isinstance(layers[0], tuple):
            for name, l in layers:
                self.add_sublayer(name, l)
        else:
            for i, l in enumerate(layers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or ()):
            self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())
