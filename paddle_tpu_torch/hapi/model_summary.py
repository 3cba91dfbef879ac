"""Model summary (counterpart of ``paddle_tpu/hapi/model_summary.py``;
ref: python/paddle/hapi/model_summary.py)."""
from __future__ import annotations


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable_params = 0
    for name, layer in net.named_sublayers(include_self=True):
        n_params = 0
        for _, p in layer._parameters.items():
            if p is not None:
                n_params += p.size
                total_params += p.size
                if not p.stop_gradient:
                    trainable_params += p.size
        if name:
            rows.append((name, type(layer).__name__, n_params))
    # params counted per-layer non-recursively, so total is correct
    print(f"{'Layer':40s}{'Type':24s}{'Params':>12s}")
    print("-" * 76)
    for name, tname, n in rows:
        print(f"{name:40.40s}{tname:24.24s}{n:>12d}")
    print("-" * 76)
    print(f"Total params: {total_params}")
    print(f"Trainable params: {trainable_params}")
    return {"total_params": int(total_params),
            "trainable_params": int(trainable_params)}
