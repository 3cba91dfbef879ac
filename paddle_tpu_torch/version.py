# Copied from paddle_tpu/version.py (the API level it reports), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Version info (ref: python/paddle/version.py generated at build).

Reports the PADDLE API LEVEL this framework implements (2.0.0, the
reference era) so reference scripts gating on paddle.__version__ /
fluid.require_version run unmodified; the package's own build identity
lives in ``tpu_native_version``/``commit``.
"""
full_version = "2.0.0"
major = "2"
minor = "0"
patch = "0"
rc = "0"
istaged = True
commit = "tpu-native"
with_mkl = "OFF"
tpu_native_version = "0.1.0"


def show():
    print(f"paddle_tpu {tpu_native_version} "
          f"(paddle API {full_version}, commit {commit})")


def mkl():
    return with_mkl
