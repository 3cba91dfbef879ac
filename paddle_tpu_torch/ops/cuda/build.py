"""Build and load the port's CUDA kernels (the counterpart of
``paddle_tpu/ops/pallas/utils.py``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``paddle_tpu_torch/_build/
lib<name>-<digest>.so``, and loaded with ``ctypes``.  No source includes
PyTorch's headers, so a build takes seconds.  The digest covers the
source, every header it includes from ``csrc/`` (``hopper.cuh``, shared
by the Hopper kernels) and the flags, so a library whose source or headers
changed is rebuilt and an unchanged one is reused.  Libraries are built at first use, never at import, and
:func:`build` starts one ``nvcc`` per missing source, all at once.

Only sources in this repository are built.  A failed build raises; there
is no switch that swaps a kernel for its plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = {"paged_attn": "paged_attn.cu", "layer_norm": "layer_norm.cu",
           "flash_attn": "flash_attn.cu",
           "dequant_matmul": "dequant_matmul.cu",
           "fused_ffn": "fused_ffn.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

_loaded = {}        # name -> ctypes.CDLL, one load per process
build_log = {}      # name -> nvcc's output (ptxas register/spill report)


def nvcc_path():
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``.  Raises ``RuntimeError`` if none
    exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "paddle_tpu_torch kernels need nvcc (CUDA toolkit) to build; none "
        "found in $CUDA_HOME/bin, PATH or /usr/local/cuda/bin")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_files(name):
    """The source of library ``name`` and every header it includes from
    ``csrc/`` (``#include "..."``, followed recursively), in a fixed
    order."""
    files, todo = [], [SOURCES[name]]
    while todo:
        f = todo.pop(0)
        if f not in files:
            files.append(f)
            todo.extend(_INCLUDE.findall((CSRC / f).read_text()))
    return files


def lib_path(name):
    h = hashlib.blake2b(digest_size=8)
    for f in source_files(name):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def build(names=None):
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` per source, all started together.  Returns the wall
    seconds spent.  Raises ``RuntimeError`` with nvcc's output if any
    compile fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not lib_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, out, tmp, p in procs:
        try:
            log, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            log += "\n[nvcc timed out after 900 s]"
        build_log[n] = log
        if p.returncode == 0 and tmp.exists():
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {SOURCES[n]} (rc={p.returncode})\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel library ``name``, built first
    if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib


def check(lib, err, what):
    """Raise if a launch returned a CUDA error code (the C side returns
    ``cudaGetLastError()`` right after its launch)."""
    if err != 0:
        msg = lib.pt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
