"""Callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``; ref:
python/paddle/hapi/callbacks.py).  ``TelemetryCallback``, ``VisualDL`` and
``ProgressBarCallback`` read the reference's ``observability`` package,
which the port does not have yet: they raise ``NotImplementedError``
(ROADMAP Queue 1 item 12).  The default list needs none of them."""
from __future__ import annotations

import os
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)
            getattr(c, f"on_{mode}_begin")(logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_end")(logs)
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_begin")(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_end")(step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self._start = None

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                              else f"{k}: {v}" for k, v in (logs or {}).items()
                              if k not in ("batch_size",))
            print(f"Epoch {self.epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - (self._start or time.time())
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                              else f"{k}: {v}" for k, v in (logs or {}).items()
                              if k not in ("batch_size", "step"))
            print(f"Epoch {epoch} done in {dur:.1f}s: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        from ..optimizer.lr import LRScheduler as Sched
        if self.by_step and isinstance(self.model._optimizer._lr, Sched):
            self.model._optimizer._lr.step()

    def on_epoch_end(self, epoch, logs=None):
        from ..optimizer.lr import LRScheduler as Sched
        if self.by_epoch and isinstance(self.model._optimizer._lr, Sched):
            self.model._optimizer._lr.step()


class EarlyStopping(Callback):
    """Stop when the monitored quantity stops improving ON EVALUATION
    data (ref hapi/callbacks.py::EarlyStopping monitors in on_eval_end —
    train-epoch logs are never consulted; fit() warns when no eval data
    is supplied)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.save_dir = None          # fit() points this at its save_dir
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode
        self.wait = 0
        self.best = None

    def _better(self, cur):
        if self.best is None:
            return (self.baseline is None
                    or (cur < self.baseline if self.mode == "min"
                        else cur > self.baseline))
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.save_dir is not None:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


_OBSERVABILITY = ("{} reads the observability package, which the port does "
                  "not have yet (ROADMAP.md Queue 1 item 12)")


class TelemetryCallback(Callback):
    """Not ported: see the module docstring."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_OBSERVABILITY.format(type(self).__name__))


class VisualDL(TelemetryCallback):
    """Not ported: see the module docstring."""


class ProgressBarCallback(Callback):
    """Not ported: see the module docstring."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_OBSERVABILITY.format(type(self).__name__))


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = callbacks if callbacks is not None else []
    cbks = cbks if isinstance(cbks, (list, tuple)) else [cbks]
    cbks = list(cbks)
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    if not any(isinstance(c, LRScheduler) for c in cbks):
        # ref callbacks.py:53 — schedulers advance PER STEP by default;
        # pass LRScheduler(by_step=False, by_epoch=True) to override
        cbks = cbks + [LRScheduler()]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    params = {"batch_size": batch_size, "epochs": epochs, "steps": steps,
              "verbose": verbose, "metrics": metrics or ["loss"]}
    cbk_list.set_params(params)
    return cbk_list
