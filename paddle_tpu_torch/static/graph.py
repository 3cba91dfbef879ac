"""Static graph: a Program is a recorded op trace, the Executor replays it
(counterpart of ``paddle_tpu/static/graph.py``).

Building a program under ``enable_static`` records every op that
``ops.dispatch.call`` runs (the op still runs, on placeholder values, so
shapes and Python control flow resolve).  ``Executor.run`` replays the
recording eagerly on the program's device, where the reference compiles
it with XLA.  A training program (``optimizer.minimize`` set its
``train_spec``) is differentiated by torch autograd with respect to the
program's parameters, then the optimizer's update runs in place on the
parameters and its accumulators (``Optimizer._apply_gradients``: its clip,
weight decay, per-parameter lr and ``need_clip``, as the reference's
``apply_updates_pytree`` applies them), and the persistable captures the
program mutated (batch norm's running statistics) are written back.

The Executor keeps one prepared replay per (program, op count, feed names,
shapes and dtypes, fetch ids, train spec) in a bounded LRU of 64, the
reference's ``static.executor`` compile-cache site; ``executor_stats``
counts its ``builds`` (the reference's compiles), ``hits`` and
``evictions``.  A run without fetches makes no host sync.  Capturing the
replay as a CUDA graph is not ported (ROADMAP Queue 1 item 2).  Static
control flow records composite ops (``static.control_flow``).

``Executor.run`` passes the feed through every hook of
``_executor_feed_hooks`` first (``fluid/reader_compat.py``'s: a started
``py_reader``'s placeholders are filled from its staged batches, moved
to the executor's place), and runs a program that
``load_inference_model`` returned through its artifact.
``train_from_dataset`` and ``infer_from_dataset`` drive one pass of a
MultiSlot dataset (``distributed/ps_compat.py``), each batch one ordinary
feed into the prepared replay.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import weakref

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework import core
from ..ops import dispatch
from ..tensor.tensor import Parameter, Tensor, _to_torch_value

_static_mode = [False]
_var_counter = itertools.count(1)
# var ids the replay can supply somewhere: feeds, parameters, op outputs
_live_var_ids = set()
# var id -> weakref(Tensor): build-time values of ids no env supplies
_var_tensors = {}

executor_stats = {"builds": 0, "hits": 0, "evictions": 0}
# hooks(program, feed, device) -> feed, run by Executor.run before it
# prepares the program (fluid's py_reader registers one); a list, so that
# static imports nothing of fluid
_executor_feed_hooks = []
# feed name -> its shape as declared (-1 for unknown dims; the placeholder
# holds 1 there), and the same by var id (a later program may declare the
# name again)
_feed_declared_shapes = {}
_declared_shapes = {}
_EXECUTOR_CACHE = 64


def in_static_mode():
    return _static_mode[0]


def _set_static_mode(flag):
    flag = bool(flag)
    if flag != _static_mode[0]:
        # to_static's graphs were captured for the other mode: drop them
        # on every flip, as the reference drops its dispatch cache
        dispatch.clear_cache()
    _static_mode[0] = flag
    dispatch.static_recorder = record_call if flag else None


class OpRecord:
    __slots__ = ("fn", "spec", "leaf_specs", "out_ids", "name", "grad")

    def __init__(self, fn, spec, leaf_specs, out_ids, name, grad):
        self.fn = fn
        self.spec = spec              # pytree spec of (args, kwargs)
        self.leaf_specs = leaf_specs  # [("var", id) | ("const", value)]
        self.out_ids = out_ids
        self.name = name
        self.grad = grad              # False: the op stays off the tape


class Program:
    def __init__(self):
        self.ops = []
        self.feed_ids = {}      # name -> var id
        self.params = {}        # var id -> Parameter
        self.var_meta = {}      # var id -> (shape, dtype)
        self.captured = {}      # var id -> Tensor (buffers, eager values)
        self.train_spec = None  # (loss var id, optimizer)
        # id(tensor) -> (weakref(tensor), produced var id): persistable
        # captures this program mutates (batch norm's running statistics);
        # the Executor writes the produced value back after each run
        self.mutated = {}
        self._avail = set()     # ids this program's replay supplies
        # grad var id -> (target id, wrt id, seed or None), minted by
        # append_backward / gradients, evaluated at fetch time
        self.grad_map = {}

    def record(self, fn, spec, leaf_specs, out_ids, name, grad=True):
        self.ops.append(OpRecord(fn, spec, leaf_specs, out_ids, name, grad))
        self._avail.update(out_ids)

    def note_mutation(self, t):
        """Register a persistable capture this program just mutated (its
        current var id is the mutation's output)."""
        self.mutated[id(t)] = (weakref.ref(t), t._var_id)

    def clone(self, for_test=False):
        """A copy; ``for_test`` drops the running-statistics updates (later
        reads of their outputs go back to the statistics they read) and
        swaps each op that has a ``__test_variant__`` (train-mode batch
        norm) for it, the reference's test-mode flip."""
        p = Program()
        p.ops = list(self.ops)
        if for_test:
            subst, ops = {}, []
            for op in p.ops:
                specs = op.leaf_specs
                if subst and any(k == "var" and r in subst
                                 for k, r in specs):
                    specs = [subst[r] if k == "var" and r in subst
                             else (k, r) for k, r in specs]
                if op.name == "bn_stats_update":
                    # _upd(rm, rv, mean, var, x): leaves 0 and 1 are the
                    # statistics it read
                    subst[op.out_ids[0]] = specs[0]
                    subst[op.out_ids[1]] = specs[1]
                    continue
                tv = getattr(op.fn, "__test_variant__", None)
                if tv is not None or specs is not op.leaf_specs:
                    op = OpRecord(tv or op.fn, op.spec, specs, op.out_ids,
                                  op.name, op.grad)
                ops.append(op)
            p.ops = ops
        p.feed_ids = dict(self.feed_ids)
        p.params = dict(self.params)
        p.var_meta = dict(self.var_meta)
        p.captured = dict(self.captured)
        p.grad_map = dict(self.grad_map)
        p.mutated = {} if for_test else dict(self.mutated)
        p._avail = set(self._avail)
        if not for_test:
            p.train_spec = self.train_spec
        return p

    def global_block(self):
        return self

    def var(self, name):
        """The build-time Tensor named ``name``: a feed, a parameter, a
        capture or an op output."""
        cands = [_var_tensors.get(self.feed_ids[name])] \
            if name in self.feed_ids else []
        cands += [weakref.ref(p) for p in self.params.values()]
        cands += [weakref.ref(t) for t in self.captured.values()]
        cands += [_var_tensors.get(v) for v in self._avail]
        for wr in cands:
            t = wr() if wr is not None else None
            if t is not None and t.name == name:
                return t
        raise ValueError(f"var '{name}' not found in this program")

    def state_dict(self, mode="all", scope=None):
        """Parameters (and, for ``mode`` "all" or "opt", persistable
        captures) by name."""
        out = {p.name: p for p in self.params.values()}
        if mode in ("all", "opt"):
            out.update({t.name: t for t in self.captured.values()
                        if t.persistable and t.name not in out})
        return out

    def set_state_dict(self, state_dict, scope=None):
        """Copy values into the parameters (and persistable captures) of
        the same name, in place."""
        by_name = {p.name: p for p in self.params.values()}
        for t in self.captured.values():
            by_name.setdefault(t.name, t)
        for k, v in state_dict.items():
            if by_name.get(k) is not None:
                by_name[k].set_value(v)

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except ValueError:
            return False

    def all_parameters(self):
        return list(self.params.values())

    def list_vars(self):
        return list(self.var_meta.keys())

    def lookup(self, env, vid):
        """A var id's value: the env, then the program's captures, then a
        build-time tensor still alive (a constant of the program)."""
        if vid in env:
            return env[vid]
        if vid in self.captured:
            return self.captured[vid].value
        wr = _var_tensors.get(vid)
        t = wr() if wr is not None else None
        if t is None:
            raise KeyError(f"program replay: var id {vid} is neither in the "
                           "env nor alive as a build tensor")
        return t.value

    def replay(self, env, skip_out=None):
        """Run the recorded ops on ``env`` (var id -> torch value), adding
        their outputs to it; ``skip_out``'s produced value is dropped (the
        value already in ``env`` stays, see :meth:`replay_cut`)."""
        grad_on = torch.is_grad_enabled()
        for op in self.ops:
            leaves = [self.lookup(env, ref) if kind == "var" else ref
                      for kind, ref in op.leaf_specs]
            args, kwargs = pytree.tree_unflatten(leaves, op.spec)
            if grad_on and not op.grad:
                with torch.no_grad():
                    out = op.fn(*args, **kwargs)
            else:
                out = op.fn(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for oid, o in zip(op.out_ids, outs):
                if oid != skip_out:
                    env[oid] = o
        return env

    def replay_cut(self, env, cut_id, cut_val):
        """Replay with var ``cut_id`` pinned to ``cut_val``: every read sees
        it and the op producing it has that output dropped, so the result
        differentiates with respect to ``cut_val`` (how ``append_backward``
        and ``gradients`` reach intermediates)."""
        env[cut_id] = cut_val
        return self.replay(env, skip_out=cut_id)


_default_main = [Program()]
_default_startup = [Program()]


def default_main_program():
    return _default_main[0]


def default_startup_program():
    return _default_startup[0]


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    saved = (_default_main[0], _default_startup[0])
    _default_main[0] = main_program
    if startup_program is not None:
        _default_startup[0] = startup_program
    try:
        yield
    finally:
        _default_main[0], _default_startup[0] = saved


def _ensure_var_id(t, program):
    """``t``'s var id (a new one on first use), registered in
    ``program``; a Parameter joins the program's parameters."""
    vid = t._var_id
    if vid is None:
        vid = t._var_id = next(_var_counter)
    if vid not in program.var_meta:
        program.var_meta[vid] = (tuple(t.shape), t.dtype)
        if isinstance(t, Parameter):
            program.params[vid] = t
            program._avail.add(vid)
            _live_var_ids.add(vid)
    _var_tensors[vid] = weakref.ref(t)
    return vid


def record_call(fn, leaves, spec, out_tensors, name):
    """The hook ``ops.dispatch.call`` runs in static mode: record ``fn`` on
    ``leaves`` (Tensors become var ids, anything else a constant) into the
    default main program."""
    prog = default_main_program()
    specs = []
    for leaf in leaves:
        if isinstance(leaf, Tensor):
            vid = _ensure_var_id(leaf, prog)
            if vid not in _live_var_ids or vid not in prog._avail:
                # a tensor this program's replay does not produce (a
                # layer's buffer, an eager value, another program's
                # output): the replay reads its live value
                prog.captured[vid] = leaf
            specs.append(("var", vid))
        else:
            specs.append(("const", leaf))
    out_ids = [_ensure_var_id(t, prog) for t in out_tensors]
    _live_var_ids.update(out_ids)
    prog.record(fn, spec, specs, out_ids, name, core.grad_enabled())


def data(name, shape, dtype="float32", lod_level=0):
    """A feed placeholder; unknown dims (None or -1) are 1 while the
    program builds, and the feed gives the real shape."""
    declared = [-1 if (s is None or s < 0) else int(s) for s in shape]
    t = Tensor(np.zeros([1 if s < 0 else s for s in declared], np.float32),
               dtype=dtype, stop_gradient=True, name=name)
    prog = default_main_program()
    vid = _ensure_var_id(t, prog)
    _feed_declared_shapes[name] = declared
    _declared_shapes[vid] = declared
    prog.feed_ids[name] = vid
    _live_var_ids.add(vid)
    prog._avail.add(vid)
    return t


class _Prepared:
    """What the Executor keeps for one cache key: the ids a run feeds,
    reads, fetches and writes back."""

    def __init__(self, program, feed_names, fetch_ids):
        self.feed_ids = [program.feed_ids[n] for n in feed_names]
        self.param_ids = sorted(program.params)
        self.params = [program.params[i] for i in self.param_ids]
        self.fetch_ids = list(fetch_ids)
        # every persistable capture that is no Parameter is read live at
        # each run (batch norm's statistics; a test clone reads them too)
        self.cap_ids = [v for v, t in program.captured.items()
                        if t.persistable and not isinstance(t, Parameter)]
        self.writebacks = [(wr, v) for wr, v in program.mutated.values()
                           if wr() is not None]


class Executor:
    """ref: ``paddle_tpu/static/graph.py::Executor``: one prepared replay
    per (program, op count, feed signature, fetch ids, train spec)."""

    def __init__(self, place=None):
        self.place = place
        self._cache = collections.OrderedDict()

    def _prepared(self, program, feed_names, feed_vals, fetch_ids):
        spec = program.train_spec
        key = (id(program), len(program.ops), tuple(feed_names),
               tuple((tuple(v.shape), v.dtype) for v in feed_vals),
               tuple(fetch_ids),
               (spec[0], id(spec[1])) if spec is not None else None)
        prep = self._cache.get(key)
        if prep is not None:
            self._cache.move_to_end(key)
            executor_stats["hits"] += 1
            return prep
        prep = _Prepared(program, feed_names, fetch_ids)
        self._cache[key] = prep
        executor_stats["builds"] += 1
        if len(self._cache) > _EXECUTOR_CACHE:
            self._cache.popitem(last=False)
            executor_stats["evictions"] += 1
        return prep

    def _feed_value(self, v):
        place = self.place if isinstance(self.place, core.Place) else None
        return _to_torch_value(v, place=place)

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kwargs):
        program = program or default_main_program()
        program = getattr(program, "_program", program)  # CompiledProgram
        if hasattr(program, "model") and hasattr(program, "run"):
            # static.load_inference_model's artifact
            return program.run(feed or {}, fetch_list)
        if not program.ops:
            return []       # startup: the parameters exist already
        feed = feed or {}
        if _executor_feed_hooks:
            dev = (self.place if isinstance(self.place, core.Place)
                   else core.get_place()).device
            for hook in _executor_feed_hooks:
                feed = hook(program, feed, dev)
        fetch_list = fetch_list or []
        if isinstance(fetch_list, (str, Tensor)):
            fetch_list = [fetch_list]
        fetch_ids = []
        for f in fetch_list:
            if isinstance(f, str):
                f = program.var(f)
            fetch_ids.append(_ensure_var_id(f, program)
                             if isinstance(f, Tensor) else f)
        feed_names = sorted(feed)
        feed_vals = [self._feed_value(feed[n]) for n in feed_names]
        prep = self._prepared(program, feed_names, feed_vals, fetch_ids)
        base = dict(zip(prep.feed_ids, feed_vals))
        base.update((v, program.captured[v].value) for v in prep.cap_ids)

        def fresh_env():
            env = dict(base)
            env.update(zip(prep.param_ids, (p.value for p in prep.params)))
            return env

        if program.train_spec is not None:
            fetches, env = self._train(program, prep, fresh_env)
        else:
            with torch.no_grad():
                env = program.replay(fresh_env())
            param_grads = self._param_grads(program, prep, fresh_env)
            fetches = [param_grads[fid] if fid in param_grads
                       else self._fetch(program, env, fid, fresh_env)
                       for fid in prep.fetch_ids]
        with torch.no_grad():
            for wr, vid in prep.writebacks:
                t = wr()
                if t is not None:
                    t.value.copy_(env[vid])
        if return_numpy:
            return [f.detach().cpu().numpy() if f.dtype != torch.bfloat16
                    else f.detach().float().cpu().numpy() for f in fetches]
        return [Tensor(f.detach()) for f in fetches]

    def _train(self, program, prep, fresh_env):
        """One training step: replay with autograd on, the loss's grads
        with respect to the parameters that train, the fetches (from the
        parameters before the update), then the optimizer's update in
        place."""
        loss_id, opt = program.train_spec
        with torch.enable_grad():
            env = program.replay(fresh_env())
        train = [p for p in prep.params
                 if not p.stop_gradient and p.value.requires_grad]
        grads = torch.autograd.grad(env[loss_id], [p.value for p in train],
                                    allow_unused=True)
        env = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in env.items()}
        fetches = [self._fetch(program, env, fid, fresh_env)
                   for fid in prep.fetch_ids]
        with torch.no_grad():
            opt._apply_gradients(list(zip(train, grads)))
        return fetches, env

    @staticmethod
    def _param_grads(program, prep, fresh_env):
        """The fetched grad vars whose wrt is a parameter, by target: one
        replay with those parameters as leaves and one ``autograd.grad``
        a target (a replay each would repeat the forward per parameter);
        {grad var id: value}."""
        groups = collections.defaultdict(list)
        params = set(prep.param_ids)
        for fid in dict.fromkeys(prep.fetch_ids):
            if fid in program.grad_map:
                tgt_id, wrt_id, seed = program.grad_map[fid]
                if wrt_id in params and seed is None:
                    groups[tgt_id].append((fid, wrt_id))
        out = {}
        for tgt_id, pairs in groups.items():
            env = fresh_env()
            leaves = {}
            for _, wrt_id in pairs:
                if wrt_id not in leaves:
                    leaves[wrt_id] = env[wrt_id].detach().requires_grad_(
                        True)
            env.update(leaves)
            with torch.enable_grad():
                t = program.replay(env)[tgt_id]
                gs = torch.autograd.grad(t.sum(), list(leaves.values()),
                                         allow_unused=True)
            by_wrt = {w: (torch.zeros_like(v) if g is None else g.detach())
                      for (w, v), g in zip(leaves.items(), gs)}
            out.update((fid, by_wrt[w]) for fid, w in pairs)
        return out

    @staticmethod
    def _fetch(program, env, fid, fresh_env):
        """A fetch id's value; a grad var of ``append_backward`` /
        ``gradients`` is d(target)/d(wrt), from a replay with the wrt
        var cut (:meth:`Program.replay_cut`)."""
        if fid not in program.grad_map:
            if fid in env:
                return env[fid]
            for nm, fvid in program.feed_ids.items():
                if fvid == fid:
                    raise KeyError(f"feed '{nm}' was not provided to run()")
            return program.lookup(env, fid)
        tgt_id, wrt_id, seed = program.grad_map[fid]
        wv = program.lookup(env, wrt_id).detach().requires_grad_(True)
        with torch.enable_grad():
            env2 = program.replay_cut(fresh_env(), wrt_id, wv)
            t = env2[tgt_id]
            s = t.sum() if seed is None else (t * seed.to(t.device)).sum()
            g, = torch.autograd.grad(s, wv, allow_unused=True)
        return torch.zeros_like(wv) if g is None else g.detach()

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """One pass of a MultiSlot dataset (ref fluid/executor.py::
        train_from_dataset; there C++ trainer threads): each parsed batch
        is an ordinary feed into the prepared replay.  The fetches print
        every ``print_period`` steps."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        program = program or default_main_program()
        fetch_list = fetch_list or []
        fetch_info = fetch_info or [f"fetch_{i}"
                                    for i in range(len(fetch_list))]
        for step, feed in enumerate(dataset.iter_batches()):
            vals = self.run(program, feed=feed, fetch_list=fetch_list)
            if fetch_list and step % max(print_period, 1) == 0:
                msg = " ".join(f"{n}={np.asarray(v).ravel()[:1]}"
                               for n, v in zip(fetch_info, vals))
                print(f"step {step}: {msg}")
        return None

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """:meth:`train_from_dataset` with the program's ``train_spec``
        suspended, so that it never applies an update."""
        program = program or default_main_program()
        saved, program.train_spec = program.train_spec, None
        try:
            return self.train_from_dataset(program, dataset, scope,
                                           thread, debug, fetch_list,
                                           fetch_info, print_period)
        finally:
            program.train_spec = saved

    def close(self):
        self._cache.clear()


class CompiledProgram:
    """ref: ``fluid/compiler.py::CompiledProgram``: the program itself on
    one device."""

    def __init__(self, program, build_strategy=None):
        self._program = program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        return self

    def __getattr__(self, item):
        return getattr(self._program, item)


class BuildStrategy:
    def __init__(self):
        self.memory_optimize = True
        self.enable_inplace = True
        self.fuse_all_optimizer_ops = True
        self.fuse_elewise_add_act_ops = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class Scope:
    def __init__(self):
        self._vars = {}

    def var(self, name):
        return self._vars.setdefault(name, Tensor(np.zeros((), np.float32)))

    def find_var(self, name):
        return self._vars.get(name)


_global_scope = [Scope()]


def global_scope():
    return _global_scope[0]


@contextlib.contextmanager
def scope_guard(scope):
    old, _global_scope[0] = _global_scope[0], scope
    try:
        yield
    finally:
        _global_scope[0] = old
