"""Hand-written CUDA kernels of the port and the launch plumbing they share.

Every kernel wrapper in this package dispatches on the device of the
tensors it is given: a CPU tensor takes the kernel's plain PyTorch
version (``ref.py`` beside the wrapper), a CUDA tensor launches the
kernel or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


class KernelEntry:
    """One C entry point of a kernel library, with its launch count.

    The entry point takes the arguments in ``argtypes`` followed by the
    CUDA stream, launches on that stream without synchronising, and
    returns ``cudaGetLastError()``; a non-zero code raises here with the
    library's ``repro_cuda_error_string`` of it.
    ``launches`` counts the launches that went through, so a run can
    show that its path really reached the kernel.
    """

    def __init__(self, library: str, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream. The device is made
        current only when it is not already, and the stream is read as
        its raw handle: both without building Python objects, since the
        MARL path's launches are a few microseconds of device time
        each."""
        if self._fn is None:
            lib = _build.load(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            err = self._fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = self._fn(*args,
                               torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            describe = _build.load(self.library).repro_cuda_error_string
            describe.argtypes = [ctypes.c_int]
            describe.restype = ctypes.c_char_p
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with "
                               f"error {err} ({describe(err).decode()})")
        self.launches += 1


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path); False
    when every one lies on a CUDA device (the kernel path). Raises on a
    mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  ndim: int) -> None:
    """Raise unless ``t`` is what a kernel takes: ``dtype``, ``ndim``
    dimensions, contiguous."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel takes a contiguous {ndim}-d {dtype} "
            f"tensor, got {t.dtype} of shape {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})")
