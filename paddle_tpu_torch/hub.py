# Copied from paddle_tpu/hub.py (local hubconf sources, stdlib only), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.hub (ref: python/paddle/hub.py).

The reference loads hubconf.py from github/gitee repos or local dirs.
This environment has zero egress, so remote sources raise a clear error;
the LOCAL source path — a directory with ``hubconf.py`` declaring
entrypoints — is fully supported (list/help/load).
"""
from __future__ import annotations

import os
import sys

HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {HUBCONF} in {repo_dir}")
    import importlib.util
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.pop("hubconf", None)
    spec.loader.exec_module(mod)
    return mod


def _resolve(repo_dir, source):
    if source != "local":
        raise RuntimeError(
            "paddle.hub: only source='local' is available in this "
            "zero-egress environment (github/gitee need network)")
    return repo_dir


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    """Entrypoint names exported by the repo's hubconf."""
    mod = _load_hubconf(_resolve(repo_dir, source))
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    mod = _load_hubconf(_resolve(repo_dir, source))
    fn = getattr(mod, model, None)
    if fn is None:
        raise ValueError(f"no entrypoint '{model}' in {repo_dir}")
    return fn.__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    """Instantiate entrypoint ``model`` from the repo's hubconf."""
    mod = _load_hubconf(_resolve(repo_dir, source))
    fn = getattr(mod, model, None)
    if fn is None:
        raise ValueError(f"no entrypoint '{model}' in {repo_dir}")
    return fn(**kwargs)
