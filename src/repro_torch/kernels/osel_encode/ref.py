"""Plain PyTorch versions of the OSEL mask encode, and the paper's baseline.

Port of ``repro.kernels.osel_encode.ref``. ``ref_mask_indices`` is what
the CUDA kernel ``osel_encode`` computes (the comparator array);
``ref_mask_matmul`` is the baseline encoder of LearningGroup section
IV-C, the mask by FLGW's own definition ``IS @ OS`` from the raw
grouping matrices (an M x G x N product), which the kernel must match
bitwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ref_mask_matmul(ig: torch.Tensor, og: torch.Tensor) -> torch.Tensor:
    """Mask via IS @ OS (the baseline's expensive path), bool (M, N).
    ig: (M, G), og: (G, N)."""
    g = ig.shape[1]
    is_mat = F.one_hot(ig.argmax(1), g).float()
    os_mat = F.one_hot(og.argmax(0), g).float().T
    return (is_mat @ os_mat) > 0.5


def ref_mask_indices(ig_idx: torch.Tensor,
                     og_idx: torch.Tensor) -> torch.Tensor:
    """Mask via index equality (what the kernel computes), bool (M, N)."""
    return ig_idx[:, None] == og_idx[None, :]


def ref_workloads(ig_idx: torch.Tensor, og_idx: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """Per-row workload = nnz of the row's pattern =
    ``|{j: og_idx[j] == ig_idx[i]}|``, int32 (M,)."""
    hist = torch.bincount(og_idx, minlength=groups)[:groups]
    return hist[ig_idx].to(torch.int32)
