"""paddle_tpu_torch.tensor: the Tensor over ``torch.Tensor`` and the op
modules (counterpart of ``paddle_tpu/tensor``), exported at
``paddle_tpu_torch.*`` under the reference's names; each module's
``_install`` binds its ops onto the Tensor as methods and operators, and
:func:`_bind_longtail` binds the rest once the package exists."""
from . import (attribute, creation, linalg, logic, manipulation, math,
               random, search, stat)
from .tensor import Parameter, Tensor
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import median, nanmedian, numel, quantile, std, var  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .random import (bernoulli, check_shape, exponential_,  # noqa: F401
                     multinomial, normal, normal_, poisson, rand, randint,
                     randint_like, randn, randperm, shuffle, standard_normal,
                     uniform, uniform_)
from .attribute import is_complex, is_floating_point, is_integer  # noqa: F401


def _bind_longtail():
    """Bind the Tensor methods that live across several modules (the
    reference's ``tensor/__init__.py::_bind_longtail``)."""
    import paddle_tpu_torch as _p
    T = Tensor
    for nm in ("add_n broadcast_shape is_empty is_tensor reverse "
               "scatter_nd shard_index slice stack strided_slice "
               "inverse floor_mod").split():
        setattr(T, nm, getattr(_p, nm))
    T.mul = math.multiply
    T.ceil_ = lambda s: s._rebind(math.ceil(s))
    T.floor_ = lambda s: s._rebind(math.floor(s))
    T.round_ = lambda s: s._rebind(math.round(s))
    T.rsqrt_ = lambda s: s._rebind(math.rsqrt(s))


def create_array(dtype="float32", initialized_list=None):
    """A tensor array: a Python list of Tensors."""
    return list(initialized_list or [])


def array_write(x, i, array=None):
    if array is None:
        array = []
    idx = int(i.item() if hasattr(i, "item") else i)
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


def array_read(array, i):
    return array[int(i.item() if hasattr(i, "item") else i)]


def array_length(array):
    """The length as a 0-d int32 tensor on the default place."""
    from ..framework import core
    import torch as _torch
    return Tensor(_torch.full((), len(array), dtype=_torch.int32,
                              device=core.get_place().device))
