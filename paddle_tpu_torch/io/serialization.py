"""paddle.save / paddle.load (counterpart of
``paddle_tpu/io/serialization.py``; ref: python/paddle/framework/io.py).

The file is the reference's pickle: a Parameter is stored as
``{"__param__": ndarray, "name": ..., "trainable": ...}``, a Tensor as
``{"__tensor__": ndarray, "name": ...}``, containers as they are.  So a
``.pdparams`` or ``.pdopt`` written by either package loads in the
other.  numpy has no bfloat16 without ``ml_dtypes``, which the port does
not import: a bfloat16 payload is stored as its raw bits, a uint16
array, with ``"dtype": "bfloat16"`` beside it, and loads back as
bfloat16 here (the reference reads those bits as uint16).  ``load``
makes Parameters and Tensors on the default place.
"""
from __future__ import annotations

import os
import pickle

from ..framework import core
from ..tensor.tensor import Parameter, Tensor, from_payload, host_payload


def _payload(t, key, **extra):
    arr, tag = host_payload(t.value)
    out = {key: arr, "name": t.name, **extra}
    if tag is not None:
        out["dtype"] = tag
    return out


def _value(obj, key):
    """The stored payload, a bfloat16 one (raw bits, dtype tag) as a
    torch tensor on the default place."""
    if "dtype" in obj:
        return from_payload(obj[key], obj["dtype"]).to(
            core.get_place().device)
    return obj[key]


def _to_storable(obj):
    if isinstance(obj, Parameter):
        return _payload(obj, "__param__", trainable=obj.trainable)
    if isinstance(obj, Tensor):
        return _payload(obj, "__tensor__")
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def _from_storable(obj):
    if isinstance(obj, dict):
        if "__param__" in obj:
            return Parameter(_value(obj, "__param__"), name=obj.get("name"),
                             trainable=obj.get("trainable", True))
        if "__tensor__" in obj:
            return Tensor(_value(obj, "__tensor__"), name=obj.get("name"))
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
