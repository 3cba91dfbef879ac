"""Layer: the module base class (counterpart of
``paddle_tpu/nn/layer/layers.py``).

Parameters are :class:`~paddle_tpu_torch.tensor.Parameter`s on the
instance, created on the default place; parameter names and shapes equal
the reference's, so ``state_dict`` keys match key for key.
:meth:`Layer.set_state_dict` is the bridge from the JAX package: it takes
a dict of numpy arrays (``{k: v.numpy() for k, v in
ref_layer.state_dict().items()}``) and, unlike the reference, refuses a
missing key, an extra key or a wrong shape.  Buffers
(:meth:`Layer.register_buffer`, batch norm's running statistics) are
Tensors on the default place; a persistable one is in ``state_dict``
beside the parameters, and the tensor itself is marked persistable, so
that a static program that captures it reads its live value at each run
and the Executor writes back what the program changes in it.
"""
from __future__ import annotations

import collections

from ...framework import core
from ...framework.param_attr import ParamAttr
from ...tensor.tensor import Parameter, Tensor
from ..initializer import Constant, XavierUniform


class HookRemoveHelper:
    _next_id = [0]

    def __init__(self, hooks):
        self._hooks = hooks
        HookRemoveHelper._next_id[0] += 1
        self._id = HookRemoveHelper._next_id[0]

    def remove(self):
        self._hooks.pop(self._id, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = core.convert_dtype(dtype)
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._non_persistable_buffer_names_set = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()

    # ------------------------------------------------------------- params
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter on the default place: ``attr``'s initializer,
        else ``default_initializer``, else zeros for a bias and
        XavierUniform for a weight.  ``attr=False`` gives ``None``."""
        if attr is False:
            return None
        dtype = core.convert_dtype(dtype) or self._dtype
        attr = ParamAttr._to_attr(attr)
        if attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        elif is_bias:
            init = Constant(0.0)
        else:
            init = XavierUniform()
        data = init(shape, dtype).to(core.get_place().device)
        p = Parameter(data, name=attr.name, trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        """Register ``parameter`` (a :class:`Parameter`, or data made one)
        under ``name``; ``None`` registers an empty slot."""
        if parameter is not None and not isinstance(parameter, Parameter):
            parameter = Parameter(parameter)
        self._parameters[name] = parameter
        return parameter

    def register_buffer(self, name, tensor, persistable=True):
        """Register ``tensor`` (a Tensor, or data made one on the default
        place) as buffer ``name``; a persistable buffer is in
        ``state_dict``."""
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        if tensor is not None:
            tensor.persistable = bool(persistable)
        self._buffers[name] = tensor
        if persistable:
            self._non_persistable_buffer_names_set.discard(name)
        else:
            self._non_persistable_buffer_names_set.add(name)
        return tensor

    # ------------------------------------------------------------ lookup
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, (Parameter, Layer)):
            if params is None:
                raise ValueError("super().__init__() must be called first")
            mine = params if isinstance(value, Parameter) else layers
            for d in (params, layers, buffers):
                if d is not mine:
                    d.pop(name, None)
            self.__dict__.pop(name, None)
            mine[name] = value
        elif buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
            else:
                buffers[name].set_value(value)
        elif params is not None and name in params and value is None:
            params[name] = None
        else:
            for d in (params, layers):
                if d is not None:
                    d.pop(name, None)
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    # --------------------------------------------------------- iteration
    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def children(self):
        for _, l in self.named_children():
            yield l

    def named_children(self):
        seen = set()
        for name, l in self._sub_layers.items():
            if l is not None and id(l) not in seen:
                seen.add(id(l))
                yield name, l

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, l in self.named_children():
            if l is None or id(l) in layers_set:
                continue
            p = prefix + ("." if prefix else "") + name
            yield from l.named_sublayers(prefix=p, include_self=True,
                                         layers_set=layers_set)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        gen = (self.named_sublayers(prefix=prefix, include_self=True)
               if include_sublayers else [(prefix, self)])
        for lp, layer in gen:
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield lp + ("." if lp else "") + name, p

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        gen = (self.named_sublayers(prefix=prefix, include_self=True)
               if include_sublayers else [(prefix, self)])
        for lp, layer in gen:
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield lp + ("." if lp else "") + name, b

    # ------------------------------------------------------------- modes
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Cast every floating parameter to ``dtype``.  Moving a Layer to
        another device is not ported: build it after ``set_device``."""
        if device is not None:
            raise NotImplementedError(
                "Layer.to(device=...) is not ported; call set_device before "
                "building the Layer")
        if dtype is not None:
            dtype = core.convert_dtype(dtype)
            for p in self.parameters():
                if p.value.is_floating_point() and p.value.dtype != dtype:
                    p.value = p.value.to(dtype)
                    p._mark()
        return self

    # ------------------------------------------------------------- hooks
    def register_forward_pre_hook(self, hook):
        h = HookRemoveHelper(self._forward_pre_hooks)
        self._forward_pre_hooks[h._id] = hook
        return h

    def register_forward_post_hook(self, hook):
        h = HookRemoveHelper(self._forward_post_hooks)
        self._forward_post_hooks[h._id] = hook
        return h

    # -------------------------------------------------------------- call
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    # -------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=""):
        dest = (collections.OrderedDict() if destination is None
                else destination)
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        gen = (self.named_sublayers(include_self=True)
               if include_sublayers else [("", self)])
        for lp, layer in gen:
            for name, b in layer._buffers.items():
                if (b is not None and name not in
                        layer._non_persistable_buffer_names_set):
                    dest[structured_name_prefix + lp + ("." if lp else "")
                         + name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each value (numpy array, Tensor or torch tensor) into the
        parameter or persistable buffer of the same name, on its device
        and in its dtype.
        Raises ``KeyError`` naming missing and extra keys and
        ``ValueError`` on a shape that differs; nothing is copied then."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        extra = [k for k in state_dict if k not in own]
        if missing or extra:
            raise KeyError(f"set_state_dict: missing keys {missing}, "
                           f"unexpected keys {extra}")
        bad = [(k, list(getattr(v, "shape", ())), own[k].shape)
               for k, v in state_dict.items()
               if tuple(getattr(v, "shape", ())) != tuple(own[k].shape)]
        if bad:
            raise ValueError(f"set_state_dict: shapes differ (key, given, "
                             f"parameter): {bad}")
        for k, v in state_dict.items():
            own[k].set_value(v)

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, l in self.named_children():
            rep = repr(l).split("\n")
            rep = [rep[0]] + ["  " + r for r in rep[1:]]
            lines.append(f"  ({name}): " + "\n".join(rep))
        main = self.__class__.__name__ + "(" + self.extra_repr()
        if lines:
            main += "\n" + "\n".join(lines) + "\n"
        return main + ")"
