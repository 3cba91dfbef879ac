"""paddle_tpu_torch.utils (counterpart of ``paddle_tpu/utils/__init__.py``):
``CheckpointManager`` and its counters, ``deprecated``.  ``unique_name``,
``lazy`` (``flops``, ``try_import``), ``cpp_extension``, ``run_check`` and
``require_version`` raise, naming ROADMAP Queue 1 item 4 (the rest of the
package); ``download`` (``get_weights_path_from_url``) needs the network,
which the port never uses."""
from . import checkpoint  # noqa: F401
from .checkpoint import (CheckpointManager, checkpoint_stats,  # noqa: F401
                         reset_checkpoint_stats)

NOT_PORTED = {"unique_name": 4, "lazy": 4, "flops": 4, "try_import": 4,
              "cpp_extension": 4, "run_check": 4, "require_version": 4,
              "install_check": 4, "download": "network",
              "get_weights_path_from_url": "network"}


def deprecated(update_to="", since="", reason=""):
    """ref python/paddle/utils/deprecated.py: warn at each call."""
    import functools
    import warnings

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f"API '{fn.__module__}.{fn.__name__}' is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f"; use '{update_to}' instead"
            if reason:
                msg += f" ({reason})"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)
        return wrapper
    return decorate


def __getattr__(name):
    item = NOT_PORTED.get(name)
    if item == "network":
        raise NotImplementedError(
            f"utils.{name} downloads weights from the network, which the "
            "port never uses: load local files (paddle.load)")
    if item is not None:
        raise NotImplementedError(
            f"utils.{name} is not ported (ROADMAP Queue 1 item 4, the rest "
            "of the package)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
