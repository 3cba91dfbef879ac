"""Shared plumbing of the port's model families: the nested-dict walk that
stands in for ``jax.tree_util`` over a parameter tree, the single-device
gradient and AdamW step of the train steps, and ``PytreeLayer``.

``PytreeLayer`` is the counterpart of ``paddle_tpu/models/common.py``: a
functional core's tree adopted as the named Parameters of an eager
``nn.Layer``, so the dygraph API (``state_dict``, ``set_state_dict``,
``parameters``) works on the same weights.  Leaves are adopted in
``jax.tree_util``'s order (keys sorted at every level) under the
reference's names (path keys joined by ``_``: ``blocks_qkv_w``), so a
reference Layer's ``state_dict`` crosses over key for key.
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from ..optimizer.functional import adamw_update
from ..tensor.tensor import Parameter


def _leaves(tree, prefix=()):
    """(path, tensor) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _build(paths, values):
    tree = {}
    for path, v in zip(paths, values):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _global_norm(grads):
    """sqrt of the sum of every leaf's fp32 sum of squares (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in _leaves(grads)))


def value_and_grad(loss_fn, params):
    """``(loss, grads)``: ``loss_fn(params)`` as a detached 0-d tensor and
    its gradient for every leaf, in a tree shaped like ``params``; a leaf
    the loss does not reach gets zeros, as ``jax.value_and_grad`` gives.
    ``params`` is left untouched."""
    paths, vals = zip(*_leaves(params))
    leaves = [p.detach().requires_grad_() for p in vals]
    loss = loss_fn(_build(paths, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), _build(paths, grads)


@torch.no_grad()
def adamw_step(params, grads, m, v, t, lr, beta1, beta2, eps, weight_decay,
               clip_norm, decays):
    """The update of a train step, in place: the global-norm clip of
    ``grads`` (when ``clip_norm``), then ``adamw_update`` on every leaf,
    with weight decay where ``decays(path)``.  No host sync: the clip is
    tensor ops, and ``t`` and ``lr`` may be tensors."""
    scale = None
    if clip_norm:
        gn = _global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for path, p in _leaves(params):
        g, mm, vv = (_at(tree, path) for tree in (grads, m, v))
        if scale is not None:
            # in fp32, as the reference's bf16 grad times its fp32 scale
            # promotes; adamw_update takes g in fp32 anyway
            g = g.float() * scale
        np_, nm, nv = adamw_update(p, g, mm, vv, lr, t, beta1, beta2, eps,
                                   weight_decay, decays(path))
        p.copy_(np_)
        mm.copy_(nm)
        vv.copy_(nv)


class PytreeLayer(Layer):
    """Holds a functional core's tree leaves as named Parameters."""

    def _adopt_tree(self, tree):
        self._paths = sorted(path for path, _ in _leaves(tree))
        self._leaf_names = ["_".join(path) for path in self._paths]
        for path, name in zip(self._paths, self._leaf_names):
            self.add_parameter(name, Parameter(_at(tree, path)))

    def _tree(self):
        return _build(self._paths,
                      [self._parameters[n] for n in self._leaf_names])
