"""Build the native host runtime (counterpart of
``paddle_tpu/runtime/build.py``).

``csrc/ptpu_runtime.cc`` is compiled by the host C++ compiler with
``-O3 -std=c++17 -shared -fPIC -pthread`` into
``paddle_tpu_torch/_build/libptpu_runtime-<digest>.so``, where the digest
covers the source and the flags, so a changed source is rebuilt and an
unchanged one reused.  Each build writes a temporary named after its
process and renames it into place, so processes that build at once (test
workers) never read a half-written library.  Built at first use, never at
import; run ``python -m paddle_tpu_torch.runtime.build`` to build ahead.
A build with no working compiler raises.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "ptpu_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def compilers():
    """The compilers tried in order: ``$CXX``, then g++, c++, clang++."""
    return [c for c in (os.environ.get("CXX"), "g++", "c++", "clang++") if c]


def lib_path() -> Path:
    h = hashlib.blake2b(digest_size=8)
    h.update(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libptpu_runtime-{h.hexdigest()}.so"


def is_built() -> bool:
    return lib_path().exists()


def build() -> Path:
    """The library's path, compiled first if it is not built yet.  Raises
    ``RuntimeError`` with each compiler's error when none succeeds."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    errors = []
    for cxx in compilers():
        cmd = [cxx, *FLAGS, str(SRC), "-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cxx}: {e}")
            continue
        if res.returncode == 0 and tmp.exists():
            os.replace(tmp, out)
            return out
        tmp.unlink(missing_ok=True)
        errors.append(f"{cxx} (rc={res.returncode}): {res.stderr.strip()}")
    raise RuntimeError("paddle_tpu_torch native runtime: no C++ compiler "
                       "built " + str(SRC) + ":\n" + "\n".join(errors))


if __name__ == "__main__":
    try:
        print(build())
    except RuntimeError as e:
        sys.exit(str(e))
