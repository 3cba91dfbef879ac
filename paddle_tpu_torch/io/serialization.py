"""paddle.save / paddle.load (counterpart of
``paddle_tpu/io/serialization.py``; ref: python/paddle/framework/io.py).

The file is the reference's pickle: a Parameter is stored as
``{"__param__": ndarray, "name": ..., "trainable": ...}``, a Tensor as
``{"__tensor__": ndarray, "name": ...}``, containers as they are.  So a
``.pdparams`` or ``.pdopt`` written by either package loads in the
other.  ``load`` makes Parameters and Tensors on the default place.
"""
from __future__ import annotations

import os
import pickle

from ..tensor.tensor import Parameter, Tensor


def _to_storable(obj):
    if isinstance(obj, Parameter):
        return {"__param__": obj.numpy(), "name": obj.name,
                "trainable": obj.trainable}
    if isinstance(obj, Tensor):
        return {"__tensor__": obj.numpy(), "name": obj.name}
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def _from_storable(obj):
    if isinstance(obj, dict):
        if "__param__" in obj:
            return Parameter(obj["__param__"], name=obj.get("name"),
                             trainable=obj.get("trainable", True))
        if "__tensor__" in obj:
            return Tensor(obj["__tensor__"], name=obj.get("name"))
        return {k: _from_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_storable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_storable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        data = pickle.load(f)
    return _from_storable(data)
