"""GradScaler (counterpart of ``paddle_tpu/amp/grad_scaler.py``): dynamic
loss scaling with the reference's API and counters.

``unscale_`` multiplies every grad by 1/scale and finds a non-finite one
on the device, one fused check a device (``torch._amp_foreach_
non_finite_check_and_unscale_``, the counterpart of the reference's one
compiled reduction); ``step`` reads that flag on the host once a step and
skips the optimizer's step when it is set.
"""
from __future__ import annotations

import collections

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False     # a bool, or a device flag until read
        self._unscaled = set()      # optimizers unscaled this step

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide the grads of ``optimizer``'s parameters by the scale, in
        place, once a step; the non-finite check stays on the device."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        by_device = collections.defaultdict(list)
        for p in optimizer._parameters:
            if p is not None and p.value.grad is not None:
                by_device[p.value.grad.device].append(p.value.grad)
        found = None
        for dev, grads in by_device.items():
            flag = torch.zeros((), dtype=torch.float32, device=dev)
            inv = torch.full((), 1.0 / self._scale, dtype=torch.float32,
                             device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, flag, inv)
            found = flag if found is None else found + flag.to(found.device)
        self._found_inf = False if found is None else found > 0

    def _found(self):
        """The step's non-finite flag as a bool (the one host read)."""
        if isinstance(self._found_inf, torch.Tensor):
            self._found_inf = bool(self._found_inf)
        return self._found_inf

    def step(self, optimizer):
        """Unscale (unless done) and step when every grad is finite.  The
        scaling counters move in :meth:`update`."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found():
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        """Backward (unless it ran from ``scaled_loss``), step, update."""
        if (scaled_loss.value.grad_fn is not None
                and not scaled_loss._backward_ran):
            scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled.clear()
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found():
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = float(sd["scale"])
        self._good_steps = int(sd["good_steps"])
        self._bad_steps = int(sd["bad_steps"])


AmpScaler = GradScaler
