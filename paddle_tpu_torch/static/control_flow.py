"""Control flow: ``cond``, ``while_loop``, ``case``, ``switch_case``
(counterpart of ``paddle_tpu/static/control_flow.py``).

* Eager: Python ``if`` / ``while`` on the predicate's value, read on the
  host; the tape records the branch taken, so gradients flow as in the
  reference's dygraph mode.
* Static (a ``Program`` being built): each branch or body is built once
  into a sub-``Program``, and ONE composite op is recorded.  Its replay
  (``Executor.run``) evaluates the predicate and replays the recorded
  branch, or replays the body while the predicate holds, as
  ``lax.cond`` / ``lax.while_loop`` do in the reference.  ``case`` and
  ``switch_case`` are chains of ``cond``.
* Inside ``jit.to_static`` on the card (``core.in_tracing`` with the
  predicate on the card) nothing may read a value on the host, since the
  forward is captured into a CUDA graph: ``cond``, ``case`` and
  ``switch_case`` compute every branch and select with ``torch.where``
  (exact for branches without side effects, as ``lax.cond``'s are;
  the nan guard and ``check_numerics`` count only in the selected one,
  ``debug.masked_flags``);
  ``while_loop``, whose trip count only the host can know, raises
  ``jit.functional.GraphBreak`` during the capture, so ``to_static`` runs
  that signature eagerly (counted under ``fallbacks``).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..framework import core


def _is_tensor(x):
    from ..tensor import Tensor
    return isinstance(x, Tensor)


def _leaves(tree):
    return pytree.tree_leaves(tree)


def _pred_scalar(pred):
    return pred.value if _is_tensor(pred) else pred


def _on_card_traced(v):
    """A tensor predicate inside to_static on the card: not read on the
    host."""
    return (core.in_tracing() and isinstance(v, torch.Tensor)
            and v.is_cuda)


def _select(pred, t_tree, f_tree):
    """``t_tree`` where ``pred`` else ``f_tree``, leaf by leaf, as an op
    of the tape (both trees built already)."""
    from ..ops import dispatch
    t_leaves, t_def = pytree.tree_flatten(t_tree)
    f_leaves, f_def = pytree.tree_flatten(f_tree)
    if t_def != f_def:
        raise ValueError("cond: true_fn and false_fn must return the same "
                         f"structure, got {t_def} vs {f_def}")
    out = []
    for a, b in zip(t_leaves, f_leaves):
        out.append(dispatch.call(
            lambda p, x, y: torch.where(p.reshape(()).bool(), x, y),
            pred, a, b, _name="select"))
    return pytree.tree_unflatten(out, t_def)


# --------------------------------------------------------------------------
# static-record machinery
# --------------------------------------------------------------------------

_branch_depth = [0]     # >0 while building inside a control-flow branch


class _BranchTrace:
    """Build a branch with recording redirected into a fresh sub-Program;
    collect its external inputs (var ids read but not produced inside,
    and outputs that are captured tensors passed through)."""

    def __init__(self, fn):
        from .graph import Program, default_main_program, program_guard
        self.sub = Program()
        _branch_depth[0] += 1
        try:
            with program_guard(self.sub):
                self.out = fn() if fn is not None else None
        finally:
            _branch_depth[0] -= 1
        # parameters first touched inside the branch join the enclosing
        # program, so the Executor passes them into the replay
        parent = default_main_program()
        for vid, p in self.sub.params.items():
            parent.params.setdefault(vid, p)
            parent.var_meta.setdefault(vid, self.sub.var_meta.get(vid))
            parent._avail.add(vid)
        self.produced = set()
        self.ext = []
        for op in self.sub.ops:
            for kind, ref in op.leaf_specs:
                if kind == "var" and ref not in self.produced \
                        and ref not in self.ext:
                    self.ext.append(ref)
            self.produced.update(op.out_ids)
        for x in _leaves(self.out):
            if _is_tensor(x):
                vid = x._var_id
                if vid is not None and vid not in self.produced \
                        and vid not in self.ext:
                    self.ext.append(vid)


def _live(ext_ids):
    """The external ids the enclosing replay's env supplies: those the
    current program produces (or feeds, or holds as parameters); inside a
    nested branch, any some recording produced (the enclosing composite
    threads it through).  The rest the sub-program reads itself (its
    captures, build-time tensors)."""
    from .graph import _live_var_ids, default_main_program
    usable = _live_var_ids if _branch_depth[0] > 0 else (
        _live_var_ids & default_main_program()._avail)
    return [v for v in ext_ids if v in usable]


def _leaf_spec(t, prog):
    """A composite input's leaf spec, as ``graph.record_call`` makes it:
    a var id, registered as a capture when this program's replay does not
    produce it."""
    from .graph import _ensure_var_id, _live_var_ids
    vid = _ensure_var_id(t, prog)
    if vid not in _live_var_ids or vid not in prog._avail:
        prog.captured[vid] = t
    return ("var", vid)


def _out_ids(tree, prog):
    from .graph import _ensure_var_id
    leaves = _leaves(tree)
    for x in leaves:
        if not _is_tensor(x):
            raise TypeError("control-flow branch outputs must be Tensors, "
                            f"got {type(x).__name__}")
    return [_ensure_var_id(x, prog) for x in leaves]


def _fresh_output_tree(tree, produced):
    """Composite outputs get their own var ids: a branch returning a
    captured tensor unchanged would otherwise alias the input's id."""
    from ..tensor import Tensor

    def remap(x):
        if _is_tensor(x) and x._var_id is not None and x._var_id in produced:
            return x
        return Tensor(x.value) if _is_tensor(x) else x
    return pytree.tree_map(remap, tree)


def _record(prog, fn, in_specs, out_tree, name):
    from .graph import _ensure_var_id, _live_var_ids
    out_ids = [_ensure_var_id(x, prog) for x in _leaves(out_tree)]
    spec = pytree.tree_flatten(((0,) * len(in_specs), {}))[1]
    prog.record(fn, spec, in_specs, out_ids, name, core.grad_enabled())
    _live_var_ids.update(out_ids)


# --------------------------------------------------------------------------
# cond
# --------------------------------------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``; both take no
    arguments (capture by closure) and return matching structures."""
    from .graph import in_static_mode
    pv = _pred_scalar(pred)
    if in_static_mode():
        return _static_cond(pred, true_fn, false_fn)
    if _on_card_traced(pv):
        from .. import debug
        p = pv.reshape(()).bool()
        with debug.masked_flags(p):
            t = true_fn() if true_fn is not None else None
        with debug.masked_flags(~p):
            f = false_fn() if false_fn is not None else None
        return _select(pred, t, f)
    if bool(pv):
        return true_fn() if true_fn is not None else None
    return false_fn() if false_fn is not None else None


def _static_cond(pred, true_fn, false_fn):
    from ..tensor import Tensor
    from .graph import default_main_program
    prog = default_main_program()
    t = _BranchTrace(true_fn)
    f = _BranchTrace(false_fn)
    t_def = pytree.tree_structure(t.out)
    f_def = pytree.tree_structure(f.out)
    if t_def != f_def:
        raise ValueError("cond: true_fn and false_fn must return the same "
                         f"structure, got {t_def} vs {f_def}")
    live = _live(list(dict.fromkeys(t.ext + f.ext)))
    t_ids = _out_ids(t.out, t.sub)
    f_ids = _out_ids(f.out, f.sub)

    def composite(p, *ext_vals):
        sub, ids = (t.sub, t_ids) if bool(p) else (f.sub, f_ids)
        env = dict(zip(live, ext_vals))
        sub.replay(env)
        return tuple(sub.lookup(env, i) for i in ids)

    pred_t = pred if _is_tensor(pred) else Tensor(torch.tensor(bool(pred)))
    in_specs = [_leaf_spec(pred_t, prog)] + [("var", v) for v in live]
    out_tree = _fresh_output_tree(t.out, t.produced)
    _record(prog, composite, in_specs, out_tree, "cond")
    return out_tree


# --------------------------------------------------------------------------
# while_loop
# --------------------------------------------------------------------------

def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """``while cond_fn(*vars): vars = body_fn(*vars)``; returns the final
    vars.  Eager runs on the host (differentiable through the tape)."""
    from .graph import in_static_mode
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("loop_vars must be a non-empty list/tuple")
    loop_vars = list(loop_vars)
    if in_static_mode():
        return _static_while(cond_fn, body_fn, loop_vars)
    cur = loop_vars
    cond_val = _pred_scalar(cond_fn(*cur))
    if _on_card_traced(cond_val):
        from ..tensor.tensor import _readable
        _readable(cond_val, "while_loop's predicate")
    while bool(cond_val):
        out = body_fn(*cur)
        cur = list(out) if isinstance(out, (list, tuple)) else [out]
        if len(cur) != len(loop_vars):
            raise ValueError("body_fn must return as many values as "
                             "loop_vars")
        cond_val = _pred_scalar(cond_fn(*cur))
    return cur


def _static_while(cond_fn, body_fn, loop_vars):
    from .graph import _ensure_var_id, default_main_program
    prog = default_main_program()
    lv_ids = [_ensure_var_id(v, prog) for v in loop_vars]
    in_specs = [_leaf_spec(v, prog) for v in loop_vars]
    ct = _BranchTrace(lambda: cond_fn(*loop_vars))
    bt = _BranchTrace(lambda: body_fn(*loop_vars))
    b_out = list(bt.out if isinstance(bt.out, (list, tuple)) else (bt.out,))
    if len(b_out) != len(loop_vars):
        raise ValueError("body_fn must return as many values as loop_vars")
    live = _live([e for e in dict.fromkeys(ct.ext + bt.ext)
                  if e not in lv_ids])
    c_id = _ensure_var_id(ct.out, ct.sub)
    b_ids = [_ensure_var_id(x, bt.sub) for x in b_out]
    n = len(loop_vars)

    def composite(*vals):
        carry, ext_vals = list(vals[:n]), vals[n:]

        def env_for(c):
            env = dict(zip(lv_ids, c))
            env.update(zip(live, ext_vals))
            return env
        while True:
            env = env_for(carry)
            ct.sub.replay(env)
            if not bool(ct.sub.lookup(env, c_id)):
                return tuple(carry)
            env = env_for(carry)
            bt.sub.replay(env)
            carry = [bt.sub.lookup(env, i) for i in b_ids]

    in_specs += [("var", v) for v in live]
    out = list(_fresh_output_tree(b_out, bt.produced))
    _record(prog, composite, in_specs, out, "while_loop")
    return out


# --------------------------------------------------------------------------
# case / switch_case
# --------------------------------------------------------------------------

_RANDOM_OPS = {"uniform_random", "gaussian_random", "randint", "bernoulli",
               "dropout", "rrelu", "alpha_dropout", "gumbel_softmax",
               "multinomial", "randperm"}


def _replay_dependent(p):
    """Can a replay change predicate ``p``?  True when anything in its
    recorded inputs, transitively, is a feed, a parameter, a mutated or
    persistable capture or a random op's output."""
    from .graph import default_main_program, in_static_mode
    if not in_static_mode():
        return False
    vid = p._var_id
    if vid is None:
        return False
    prog = default_main_program()
    sources = set(prog.feed_ids.values()) | set(prog.params)
    sources |= {v for _, v in prog.mutated.values()}
    sources |= {v for v, t in prog.captured.items() if t.persistable}
    sources |= {o for op in prog.ops if op.name in _RANDOM_OPS
                for o in op.out_ids}
    producers = {}
    for op in prog.ops:
        ins = [r for k, r in op.leaf_specs if k == "var"]
        for o in op.out_ids:
            producers[o] = ins
    seen, stack = set(), [vid]
    while stack:
        v = stack.pop()
        if v in sources:
            return True
        if v in seen:
            continue
        seen.add(v)
        stack.extend(producers.get(v, ()))
    return False


def _const_bool(p):
    """A predicate's value when the build already fixes it, else None."""
    v = _pred_scalar(p)
    if _on_card_traced(v):
        return None
    if _is_tensor(p) and _replay_dependent(p):
        return None
    try:
        return bool(v)
    except Exception:                                  # noqa: BLE001
        return None


def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds runs (the last fn is the
    default when none is given); a chain of ``cond``s.  Predicates the
    build already fixes resolve at once, so their branches may differ in
    shape and dtype."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    pairs = list(pred_fn_pairs)
    for pair in pairs:
        if not (isinstance(pair, (tuple, list)) and len(pair) == 2
                and callable(pair[1])):
            raise TypeError("each pred_fn_pair must be (pred, callable)")
    if default is None:
        default = pairs[-1][1]
    consts = [_const_bool(p) for p, _ in pairs]
    if all(c is not None for c in consts):
        for c, (_, fn) in zip(consts, pairs):
            if c:
                return fn()
        return default()
    chain = default
    for pred, fn in reversed(pairs):
        chain = (lambda p=pred, f=fn, nxt=chain: lambda: cond(p, f, nxt))()
    return chain()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """``branch_fns[branch_index]()``; ``branch_fns`` is a list of
    callables, a list of (index, callable) or a dict.  An index with no
    branch runs ``default`` (the last branch when None)."""
    from .graph import in_static_mode
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        pairs = sorted((int(i), f) for i, f in branch_fns)
    else:
        pairs = list(enumerate(branch_fns))
    if default is None:
        default = pairs[-1][1]
    iv = _pred_scalar(branch_index)
    if not in_static_mode() and not _on_card_traced(iv):
        return dict(pairs).get(int(iv), default)()
    return case([(_eq_tensor(branch_index, k), f) for k, f in pairs],
                default=default)


def _eq_tensor(idx, k):
    from ..ops import dispatch
    from ..tensor import Tensor
    if _is_tensor(idx):
        return dispatch.call(lambda i: (i.to(torch.int32) == k).reshape(()),
                             idx, _name="switch_eq")
    return Tensor(torch.tensor(int(idx) == k))
