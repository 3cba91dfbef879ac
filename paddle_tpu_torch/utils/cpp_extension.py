"""paddle.utils.cpp_extension (counterpart of
``paddle_tpu/utils/cpp_extension.py``; ref:
python/paddle/utils/cpp_extension/): just-in-time native extensions.

As in the reference, an extension is a plain C-ABI shared library loaded
through ctypes, the mechanism of the port's own runtime
(``paddle_tpu_torch/runtime``): ``load`` compiles the sources with the
host toolchain (``$CXX``, g++ by default) into a cached ``.so`` and
returns the loaded library.  The default build directory is
``$PADDLE_EXTENSION_DIR``, else ``paddle_tpu_torch/_build/extensions``
(the reference's is under the home directory).
"""
from __future__ import annotations

import os
import subprocess

_DEFAULT_BUILD_DIR = os.environ.get("PADDLE_EXTENSION_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build",
    "extensions")


def get_build_directory():
    os.makedirs(_DEFAULT_BUILD_DIR, exist_ok=True)
    return _DEFAULT_BUILD_DIR


def load(name, sources, extra_cxx_flags=None, extra_ldflags=None,
         build_directory=None, verbose=False, **kwargs):
    """Compile ``sources`` (C/C++) into ``<build_dir>/<name>.so`` and
    return the ctypes.CDLL.  Recompiles only when a source is newer than
    the cached library; a failed build raises ``RuntimeError`` with the
    compiler's errors."""
    import ctypes

    build_dir = build_directory or get_build_directory()
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, f"{name}.so")
    sources = [os.path.abspath(s) for s in sources]
    for s in sources:
        if not os.path.exists(s):
            raise FileNotFoundError(s)

    stale = (not os.path.exists(lib_path)
             or any(os.path.getmtime(s) > os.path.getmtime(lib_path)
                    for s in sources))
    if stale:
        cxx = os.environ.get("CXX", "g++")
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
        cmd += (extra_cxx_flags or [])
        cmd += sources + ["-o", tmp]
        cmd += (extra_ldflags or [])
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if verbose:
            print(" ".join(cmd))
            print(res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"cpp_extension build of '{name}' failed:\n{res.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path)


class CppExtension:
    """setuptools-style descriptor (ref CppExtension); consumed by
    ``setup`` below."""

    def __init__(self, sources, name=None, **kwargs):
        self.sources = sources
        self.name = name or "paddle_ext"
        self.kwargs = kwargs


def setup(name=None, ext_modules=None, **kwargs):
    """Minimal analogue of cpp_extension.setup: builds each extension
    eagerly into the cache dir; returns the loaded libraries."""
    exts = ext_modules or []
    if isinstance(exts, CppExtension):
        exts = [exts]
    return [load(e.name if e.name != "paddle_ext" else (name or e.name),
                 e.sources, **e.kwargs) for e in exts]
