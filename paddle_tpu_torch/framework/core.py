"""Global framework state of the port: dtypes, places, grad mode, RNG.

Counterpart of ``paddle_tpu/framework/core.py``.  Places map onto
``torch.device`` through :func:`paddle_tpu_torch.device.resolve_device`.
The default place is the card (``CUDAPlace(0)``): with no GPU, the first
call that needs a place raises unless :func:`set_device` asked for
``"cpu"``.  Unlike the reference's ``_default_place``, the port never
falls back to the CPU on its own, and no environment variable picks the
device.

The grad-enabled flag is torch's own grad mode, so ``no_grad`` here and
``torch.no_grad`` are one switch.  Draws come from :class:`Generator`:
initializers from its CPU ``torch.Generator``, dropout masks from a
``torch.Generator`` on the tensor's own device, seeded from the same seed
(:meth:`Generator.on`).  The reference's JAX keys give other numbers from
the same seed, so the two packages meet through carried weights, never
through a seed.  ``amp_state`` is the active ``amp.auto_cast`` (``None``
outside one), as in the reference.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..device import resolve_device

# --------------------------------------------------------------------------
# dtypes
# --------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "fp32": torch.float32, "fp64": torch.float64, "fp16": torch.float16,
    "bf16": torch.bfloat16,
}
# The reference runs JAX with x64 disabled, where 64-bit types narrow to
# their 32-bit forms; the port keeps the same dtypes.
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def convert_dtype(dtype):
    """A paddle-style dtype spec (name, ``torch.dtype`` or numpy dtype) ->
    ``torch.dtype``, 64-bit types narrowed as the reference narrows them.
    ``None`` stays ``None``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        d = dtype
    elif isinstance(dtype, str) and dtype in _DTYPE_ALIASES:
        d = _DTYPE_ALIASES[dtype]
    else:
        d = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
    return _NARROW.get(d, d)


def dtype_or_default(dtype):
    """:func:`convert_dtype` of ``dtype``, or the default dtype for
    ``None``."""
    return convert_dtype(dtype) or _state.default_dtype


def narrow(t):
    """``t`` with a 64-bit dtype narrowed as :func:`convert_dtype` does."""
    d = _NARROW.get(t.dtype)
    return t if d is None else t.to(d)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# places
# --------------------------------------------------------------------------

class Place:
    """A device of the port: the CPU or one CUDA card."""

    def __init__(self, device):
        self._device = device

    @property
    def device(self) -> torch.device:
        return self._device

    def get_device_id(self) -> int:
        return self._device.index or 0

    def __eq__(self, other):
        return isinstance(other, Place) and self._device == other._device

    def __hash__(self):
        return hash(self._device)

    def __repr__(self):
        if self._device.type == "cpu":
            return "Place(cpu)"
        return f"Place(gpu:{self.get_device_id()})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__(resolve_device("cpu"))


class CUDAPlace(Place):
    """One CUDA card; raises at construction when no GPU is visible."""

    def __init__(self, device_id: int = 0):
        super().__init__(resolve_device(f"cuda:{int(device_id)}"))


def place_of(device) -> Place:
    """The :class:`Place` of a ``torch.device``."""
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index or 0)


def _parse_device(device: str) -> Place:
    spec = device.lower().strip()
    if spec == "cpu":
        return CPUPlace()
    kind, _, idx = spec.partition(":")
    if kind in ("gpu", "cuda"):
        return CUDAPlace(int(idx) if idx else 0)
    raise ValueError(f"paddle_tpu_torch runs on 'gpu' (CUDA) or 'cpu', got "
                     f"{device!r}")


# --------------------------------------------------------------------------
# global state
# --------------------------------------------------------------------------

class _State(threading.local):
    def __init__(self):
        self.default_dtype = torch.float32
        self.expected_place = None
        self.amp_state = None
        self.tracing = False


_state = _State()


def get_default_dtype():
    return _state.default_dtype


def set_default_dtype(d):
    d = convert_dtype(d)
    if d not in (torch.float16, torch.float32, torch.bfloat16):
        raise TypeError("set_default_dtype only supports float16/bfloat16/"
                        f"float32, got {d}")
    _state.default_dtype = d


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled_flag(flag: bool):
    torch.set_grad_enabled(bool(flag))


def in_tracing() -> bool:
    """True inside ``jit.to_static``'s forward (``jit.functional.
    trace_mode``), where tensor predicates are not read on the host."""
    return _state.tracing


def set_tracing(flag: bool):
    _state.tracing = bool(flag)


def get_place() -> Place:
    """The place new tensors and parameters go to: the card unless
    :func:`set_device` said otherwise."""
    if _state.expected_place is None:
        _state.expected_place = CUDAPlace(0)
    return _state.expected_place


def set_device(device) -> Place:
    """``"gpu"``, ``"gpu:N"``, ``"cuda[:N]"``, ``"cpu"`` or a
    :class:`Place`."""
    _state.expected_place = (device if isinstance(device, Place)
                             else _parse_device(device))
    return _state.expected_place


def get_device() -> str:
    p = get_place()
    return "cpu" if p.device.type == "cpu" else f"gpu:{p.get_device_id()}"


# --------------------------------------------------------------------------
# RNG
# --------------------------------------------------------------------------

class Generator:
    """Seeded draws.  ``torch`` is a CPU ``torch.Generator`` (initializers
    draw there and move, so one seed gives the same weights on every
    device); :meth:`on` gives a ``torch.Generator`` on a device, made at
    first use and seeded with the same seed, for draws that stay where
    their tensor is (dropout masks)."""

    def __init__(self, seed: int = 0):
        self.torch = torch.Generator()
        self._on = {}
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        """Seed every stream.  A device stream made already is re-seeded
        in place, so a CUDA graph that registered it draws from the new
        seed at its next replay."""
        self._seed = int(seed)
        self.torch.manual_seed(self._seed)
        for gen in self._on.values():
            gen.manual_seed(self._seed)
        return self

    def get_state(self):
        """The seed and every stream's position (the CPU's and each
        device's made so far), for :meth:`set_state`."""
        return {"seed": self._seed, "cpu": self.torch.get_state(),
                "devices": {d: g.get_state() for d, g in self._on.items()}}

    def set_state(self, state):
        """Return every stream to where :meth:`get_state` found it (a
        device stream made since then starts again from the seed); the
        stream objects stay the same."""
        self._seed = state["seed"]
        self.torch.set_state(state["cpu"])
        for d, gen in self._on.items():
            if d in state["devices"]:
                gen.set_state(state["devices"][d])
            else:
                gen.manual_seed(self._seed)
        for d, st in state["devices"].items():
            self.on(d).set_state(st)

    def on(self, device) -> torch.Generator:
        """The generator for draws on ``device`` (the CPU's is
        :attr:`torch`)."""
        device = torch.device(device)
        if device.type == "cpu":
            return self.torch
        gen = self._on.get(device)
        if gen is None:
            gen = self._on[device] = torch.Generator(
                device=device).manual_seed(self._seed)
        return gen


_generator = Generator(int.from_bytes(os.urandom(4), "little") >> 1)


def seed(s: int):
    """Seed the default generator (and numpy's, as the reference does)."""
    _generator.manual_seed(int(s))
    np.random.seed(int(s) % (2 ** 32))
    return _generator


def default_generator() -> Generator:
    return _generator
