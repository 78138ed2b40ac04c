"""Build the CUDA sources under ``csrc/`` and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone into ``build/repro_torch/lib<name>-<digest>.so`` at the
root of the checkout (no PyTorch headers, so a build takes seconds). The
digest covers the source and the flags, so an edited source never loads
a stale library. Builds happen on first use, or up front for all
sources at once through :func:`build` (one ``nvcc`` per source, run in
parallel).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
CHECKOUT = CSRC.parents[2]
BUILD_DIR = CHECKOUT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("plan_encode", "flgw_matmul", "flash_attention", "osel_encode")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the repro_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _check_checkout() -> None:
    """The kernels build only from a checkout's ``src/repro_torch``, so the
    cache stays inside that checkout and is never shared with another."""
    if CSRC.parents[1].name != "src":
        raise RuntimeError(
            f"repro_torch is imported from {CSRC.parents[1]}, not from a "
            "checkout's src/ directory: put <checkout>/src on the path so "
            "the kernels build into <checkout>/build/repro_torch")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    _check_checkout()
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once. Returns ``{name: compiler output}`` for
    the libraries built by this call (ptxas register and shared-memory
    report included); raises with the compiler's output on a failure."""
    _check_checkout()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for "
                           + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
