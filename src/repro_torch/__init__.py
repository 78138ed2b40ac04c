"""PyTorch/CUDA port of the LearningGroup FLGW engine for NVIDIA Hopper.

``repro_torch`` mirrors ``repro``'s layout module for module
(``repro.core.grouped`` <-> ``repro_torch.core.grouped`` and so on), in
PyTorch idiom: ``nn.Module``s and plain functions on tensors, an explicit
``device``, explicit ``torch.Generator``s, an explicit batch dimension
where the JAX package used ``vmap``, and a Python loop where it used
``lax.scan``. The Pallas TPU kernels on the ported path are hand-written
CUDA C++ for ``sm_90a`` under ``csrc/``; their plain PyTorch versions sit
beside them and run only for tensors that lie on the CPU.

This package imports neither ``jax`` nor anything of ``repro``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; without one this raises instead of
    falling back to the CPU. Pass ``device="cpu"`` to run the plain
    PyTorch path on purpose.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
