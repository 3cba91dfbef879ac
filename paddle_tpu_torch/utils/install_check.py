"""paddle.utils.run_check (counterpart of
``paddle_tpu/utils/install_check.py``; ref:
python/paddle/utils/install_check.py): check the install with a forward,
a backward and an optimizer step of a tiny ``Linear`` on the card (the
default), or on the CPU where the caller asks.  The reference also sums a
sharded array over a mesh when it sees several devices; the port's
multi-card path waits for ROADMAP Queue 1 item 13, and the check says so
where it sees more than one card."""
from __future__ import annotations


def run_check(device=None):
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.device import DEFAULT_DEVICE, resolve_device
    from paddle_tpu_torch.framework import core

    dev = resolve_device(device or DEFAULT_DEVICE)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"Running verify PaddlePaddle(PyTorch/CUDA port) ... device: "
          f"{name} ({dev.type}) x{count}")
    prev = core._state.expected_place
    try:
        paddle.set_device("gpu" if dev.type == "cuda" else "cpu")
        lin = paddle.nn.Linear(4, 4)
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=lin.parameters())
        x = paddle.to_tensor(np.ones((2, 4), np.float32))
        loss = (lin(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if loss.value.device.type != dev.type:
            raise RuntimeError(f"run_check ran on {loss.value.device}, "
                               f"not {dev}")
        assert np.isfinite(float(loss))
    finally:
        core._state.expected_place = prev
    if count > 1:
        print(f"{count} cards are visible; the multi-card check waits for "
              "ROADMAP Queue 1 item 13 (multi-GPU training).")
    print("PaddlePaddle(PyTorch/CUDA port) is installed successfully!")
