"""High-level Model API (counterpart of ``paddle_tpu/hapi/model.py``; ref:
python/paddle/hapi/model.py).

The reference's ``prepare`` builds one jitted functional train step.  The
port has no ``jit``; its ``Model`` drives the eager tape instead: the
network's forward records, the loss's ``backward()`` fills each trainable
parameter's ``.grad``, and the optimizer's ``step()`` (one multi-tensor
update for SGD, Momentum, Adam and AdamW) applies clip, decay and the
per-parameter lr in the reference's order.  The results equal the
reference's:

* a trainable parameter the loss does not reach gets a zero gradient, as
  ``jax.value_and_grad`` gives it (so AdamW's decoupled decay still acts
  on it);
* ``train_batch(update=False)`` accumulates gradients; the next update
  applies the mean of the micro-batch gradients (their sum divided by the
  count), clipped as a whole, in one optimizer step; ``fit`` updates on
  every ``accumulate_grad_batches``-th batch and on the epoch's last;
* ``eval_batch`` and ``predict_batch`` run in ``eval()`` mode under
  ``no_grad``.

Each train batch reads its loss back to the host (``[loss.numpy()]``)
and each metric reads the logits (``Tensor.numpy()``): one or two
device-to-host syncs a step, the reference's semantics.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..autograd import no_grad
from ..metric import Metric
from ..tensor.tensor import Tensor
from . import callbacks as cbks_mod


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _wrap_batch(x):
    """Batch leaves -> Tensors on the default place."""
    from ..io.dataloader import _to_place
    if isinstance(x, Tensor):
        return _to_place(x)
    if isinstance(x, (list, tuple)):
        return [_wrap_batch(v) for v in x]
    return Tensor(np.asarray(x))


def _host(t):
    """A Tensor output as a numpy array (bf16 read as float32)."""
    v = t.value.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()


def _names(m):
    return m.name() if isinstance(m.name(), list) else [m.name()]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        # a single InputSpec is accepted (ref hapi _verify_spec wraps it)
        if inputs is not None and not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        if labels is not None and not isinstance(labels, (list, tuple)):
            labels = [labels]
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._accum_count = 0
        self.stop_training = False

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        self._accum_count = 0
        return self

    # ------------------------------------------------------------ stepping
    def _compute_loss(self, out, labels):
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return self._loss(*outs, *labels)

    def _trainable(self):
        return [p for p in self.network.parameters() if not p.stop_gradient]

    @torch.no_grad()
    def _apply_update(self):
        """One optimizer step with the mean of the gradients accumulated
        since the last one; then every gradient is cleared."""
        k = self._accum_count
        if k == 0:
            return
        self._accum_count = 0
        params = self._trainable()
        for p in params:
            g = p.value.grad
            if g is None:
                p.value.grad = torch.zeros_like(p.value)
            elif k > 1:
                g.div_(float(k))
        self._optimizer.step()
        for p in params:
            p.clear_grad()

    def train_batch(self, inputs, labels=None, update=True):
        """One training step.  ``update=False`` (gradient accumulation)
        adds this batch's gradients without touching the parameters; the
        next ``update=True`` call applies one optimizer step with the mean
        of the accumulated micro-batch gradients (ref hapi semantics)."""
        self.network.train()
        ins = _wrap_batch(_as_list(inputs))
        labs = _wrap_batch(_as_list(labels))
        out = self.network(*ins)
        loss = self._compute_loss(out, labs)
        loss.backward()
        self._accum_count += 1
        if update:
            self._apply_update()
        metrics_out = self._update_metrics(out, labs)
        loss_np = _host(loss)
        return ([loss_np], metrics_out) if self._metrics else [loss_np]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        ins = _wrap_batch(_as_list(inputs))
        labs = _wrap_batch(_as_list(labels))
        with no_grad():
            out = self.network(*ins)
            loss = (self._compute_loss(out, labs)
                    if self._loss is not None else None)
        metrics_out = self._update_metrics(out, labs)
        if loss is None:
            return metrics_out
        loss_np = _host(loss)
        return ([loss_np], metrics_out) if self._metrics else [loss_np]

    def predict_batch(self, inputs):
        self.network.eval()
        ins = _wrap_batch(_as_list(inputs))
        with no_grad():
            out = self.network(*ins)
        return [_host(o) for o in _as_list(out)]

    def _update_metrics(self, out, labels):
        res = []
        outs = _as_list(out)
        for m in self._metrics:
            correct = m.compute(outs[0], labels[0])
            res.append(m.update(correct))
        return res

    # ----------------------------------------------------------------- fit
    def _loader(self, data, batch_size, shuffle=False, drop_last=False,
                num_workers=0):
        from ..io import DataLoader, Dataset
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        train_loader = self._loader(train_data, batch_size, shuffle,
                                    drop_last, num_workers)
        eval_loader = (self._loader(eval_data, batch_size,
                                    num_workers=num_workers)
                       if eval_data is not None else None)
        try:
            steps = len(train_loader)      # an IterableDataset's loader
        except TypeError:                  # raises (ref _len_data_loader)
            steps = None
        metric_names = [n for m in self._metrics for n in _names(m)]
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose, metrics=["loss"] + metric_names)
        if eval_loader is None and any(
                isinstance(c, cbks_mod.EarlyStopping)
                for c in cbks.callbacks):
            warnings.warn("EarlyStopping needs validation data "
                          "(it monitors eval logs)", UserWarning,
                          stacklevel=2)
        if save_dir is not None:
            for c in cbks.callbacks:      # the best model's target
                if isinstance(c, cbks_mod.EarlyStopping) \
                        and c.save_dir is None:
                    c.save_dir = save_dir
        cbks.on_begin("train")
        total_iters = 0
        done = False
        # a previous fit or num_iters break must not leak accumulated
        # gradients into this run's first update
        self._discard_accumulated()
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_batch_begin("train", step, logs)
                inputs, labels = self._split_batch(batch)
                # update on every accumulate_grad_batches-th batch and on
                # the epoch's last (a partial window applies its mean)
                do_update = ((step + 1) % accumulate_grad_batches == 0
                             or (steps is not None and step == steps - 1))
                result = self.train_batch(inputs, labels, update=do_update)
                logs = self._make_logs(result)
                logs["step"] = step
                logs["batch_size"] = batch_size
                # the per-step LR schedule rides the LRScheduler callback
                cbks.on_batch_end("train", step, logs)
                total_iters += 1
                if num_iters is not None and total_iters >= num_iters:
                    done = True           # num_iters bounds TOTAL steps
                    break
            # a loader of unknown length or a num_iters break can leave a
            # partial window: it applies now, never across epochs
            self._apply_update()
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                # eval flows through the callbacks so EarlyStopping sees
                # the eval metrics (ref fit:1718)
                cbks.on_begin("eval", {"metrics": metric_names})
                eval_logs = self.evaluate(eval_loader,
                                          batch_size=batch_size,
                                          verbose=0,
                                          num_workers=num_workers)
                cbks.on_end("eval", eval_logs)
            if self.stop_training or done:
                break
        cbks.on_end("train", logs)
        return self

    def _discard_accumulated(self):
        self._accum_count = 0
        for p in self._trainable():
            p.clear_grad()

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)):
            # the declared inputs spec is authoritative (ref hapi splits
            # by len(self._inputs)); without one, one input, rest labels
            n_in = len(self._inputs) if self._inputs else 1
            return list(batch[:n_in]), list(batch[n_in:])
        return [batch], []

    def _make_logs(self, result):
        logs = {}
        if isinstance(result, tuple):
            losses, metrics = result
        else:
            losses, metrics = result, []
        logs["loss"] = float(np.asarray(losses[0]).reshape(-1)[0])
        for m, _ in zip(self._metrics, metrics):
            accs = m.accumulate()
            accs = accs if isinstance(accs, list) else [accs]
            for n, a in zip(_names(m), accs):
                logs[n] = a
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._loader(eval_data, batch_size,
                              num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        logs = {}
        for step, batch in enumerate(loader):
            inputs, labels = self._split_batch(batch)
            result = self.eval_batch(inputs, labels)
            logs = self._make_logs(result)
            if num_iters is not None and step + 1 >= num_iters:
                break
        eval_result = {}
        for m in self._metrics:
            accs = m.accumulate()
            accs = accs if isinstance(accs, list) else [accs]
            for n, a in zip(_names(m), accs):
                eval_result[n] = a
        if "loss" in logs:
            eval_result["loss"] = logs["loss"]
        return eval_result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size,
                              num_workers=num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(inputs))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # ------------------------------------------------------------- persist
    def save(self, path, training=True):
        from ..io.serialization import save
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..io.serialization import load
        self.network.set_state_dict(load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(load(opt_path))
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size, dtypes=dtype)
