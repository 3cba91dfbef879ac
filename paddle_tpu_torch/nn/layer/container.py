"""Containers (counterpart of ``paddle_tpu/nn/layer/container.py``):
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict``."""
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


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        return self._sub_layers.pop(key)

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for k, v in items:
            self.add_sublayer(k, v)
        return self
