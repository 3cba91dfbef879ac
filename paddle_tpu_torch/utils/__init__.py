"""paddle_tpu_torch.utils (counterpart of ``paddle_tpu/utils/__init__.py``):
``CheckpointManager`` and its counters, ``deprecated``, ``unique_name``,
``lazy`` (``flops``, ``try_import``), ``cpp_extension``, ``run_check``
and ``require_version``.  ``download`` (``get_weights_path_from_url``)
needs the network, which the port never uses, and raises."""
from . import checkpoint  # noqa: F401
from . import cpp_extension, lazy, unique_name  # noqa: F401
from .checkpoint import (CheckpointManager, checkpoint_stats,  # noqa: F401
                         reset_checkpoint_stats)
from .install_check import run_check  # noqa: F401
from .lazy import flops, try_import  # noqa: F401

NOT_PORTED = {"download": "network", "get_weights_path_from_url": "network"}


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


def require_version(min_version, max_version=None):
    """ref: python/paddle/utils/__init__.py::require_version -- raise unless
    the installed version is inside [min_version, max_version]."""
    from .. import __version__

    def _parts(v, width):
        ps = [int(p) for p in str(v).split(".") if p.isdigit()]
        return ps + [0] * (width - len(ps))   # "0.1" == "0.1.0"
    w = max(len(str(v).split(".")) for v in
            (__version__, min_version, max_version or "0"))
    cur = _parts(__version__, w)
    if _parts(min_version, w) > cur:
        raise Exception(
            f"paddle_tpu_torch version {__version__} < required "
            f"{min_version}")
    if max_version is not None and _parts(max_version, w) < cur:
        raise Exception(
            f"paddle_tpu_torch version {__version__} > allowed "
            f"{max_version}")
    return True


def __getattr__(name):
    item = NOT_PORTED.get(name)
    if item == "network":
        raise NotImplementedError(
            f"utils.{name} downloads weights from the network, which the "
            "port never uses: load local files (paddle.load)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
