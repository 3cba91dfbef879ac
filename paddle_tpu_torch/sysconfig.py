"""paddle.sysconfig (counterpart of ``paddle_tpu/sysconfig.py``; ref:
python/paddle/sysconfig.py): where the port's headers and built
libraries are.

``get_include()`` is the directory of the kernels' CUDA sources and their
shared header (``ops/cuda/csrc``, ``hopper.cuh``); ``get_lib()`` the
directory the kernel libraries and the native runtime are built into at
first use (``_build``)."""
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def get_include():
    return os.path.join(_HERE, "ops", "cuda", "csrc")


def get_lib():
    return os.path.join(_HERE, "_build")
