"""The OSEL mask encode on its CUDA kernel.

Port of ``repro.kernels.osel_encode.ops``. :func:`osel_mask` launches
``osel_encode`` of ``csrc/osel_encode.cu`` for CUDA tensors and runs its
plain version (``ref.ref_mask_indices``) for CPU ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelEntry, on_cpu
from repro_torch.kernels.osel_encode import ref as _ref

_P, _I = ctypes.c_void_p, ctypes.c_int
OSEL = KernelEntry("osel_encode", "osel_encode", [_P, _P, _P, _I, _I])


def osel_mask(ig_idx: torch.Tensor, og_idx: torch.Tensor) -> torch.Tensor:
    """OSEL mask ``ig_idx[:, None] == og_idx[None, :]`` as (M, N) uint8,
    from the (M,) and (N,) grouping-index vectors (any integer type)."""
    if ig_idx.dim() != 1 or og_idx.dim() != 1:
        raise ValueError(f"osel_mask takes two 1-d index vectors, got "
                         f"{tuple(ig_idx.shape)} and {tuple(og_idx.shape)}")
    if on_cpu(ig_idx, og_idx):
        return _ref.ref_mask_indices(ig_idx, og_idx).to(torch.uint8)
    ig = ig_idx.to(torch.int32).contiguous()
    og = og_idx.to(torch.int32).contiguous()
    m, n = ig.shape[0], og.shape[0]
    out = torch.empty((m, n), dtype=torch.uint8, device=ig.device)
    if m and n:
        OSEL(ig.device, ig.data_ptr(), og.data_ptr(), out.data_ptr(), m, n)
    return out


def reference_mask(ig: torch.Tensor, og: torch.Tensor) -> torch.Tensor:
    """Baseline IS @ OS mask (bool) from the raw grouping matrices."""
    return _ref.ref_mask_matmul(ig, og)
