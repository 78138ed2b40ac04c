"""Compact FLGW matmul on the grouped-bmm CUDA kernel.

Pipeline, as in ``repro.kernels.flgw_matmul.ops.grouped_matmul``:

  1. gather   x -> x_c (G, B, capM)     activations of each group
  2. gather   W -> W_c (G, capM, capN)  the unmasked weights only
  3. kernel   y_c = x_c @ W_c           ``grouped_bmm`` (FLOPs / G)
  4. scatter  y_c -> y (B, N)           compact outputs to dense columns

The kernel masks ragged tile edges itself, so nothing is padded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelEntry, check_operand, on_cpu
from repro_torch.kernels.flgw_matmul import ref as _ref

_P, _I = ctypes.c_void_p, ctypes.c_int
BMM = KernelEntry("flgw_matmul", "grouped_bmm_f32", [_P, _P, _P, _I, _I, _I, _I])


def grouped_bmm(xg: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """(G, B, capM) @ (G, capM, capN) -> (G, B, capN), float32 only on
    the card. See :func:`ref.ref_grouped_bmm`."""
    if on_cpu(xg, wc):
        return _ref.ref_grouped_bmm(xg, wc)
    check_operand(xg, "xg", torch.float32, 3)
    check_operand(wc, "wc", torch.float32, 3)
    g, b, k = xg.shape
    if wc.shape[:2] != (g, k):
        raise ValueError(f"xg {tuple(xg.shape)} and wc {tuple(wc.shape)} "
                         "do not chain")
    n = wc.shape[2]
    y = torch.empty((g, b, n), dtype=torch.float32, device=xg.device)
    if y.numel():
        BMM(xg.device, xg.data_ptr(), wc.data_ptr(), y.data_ptr(), g, b, k, n)
    return y


def gather_operands(x: torch.Tensor, w: torch.Tensor, row_ids: torch.Tensor,
                    col_ids: torch.Tensor, row_valid: torch.Tensor,
                    col_valid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-2: the compact operands ``(x_c, W_c)`` of one layer, with
    the padding slots zeroed."""
    b = x.shape[0]
    g, cap_m = row_ids.shape
    xg = x[:, row_ids.reshape(-1)].reshape(b, g, cap_m).permute(1, 0, 2)
    xg = torch.where(row_valid[:, None, :], xg, 0).contiguous()
    wc = w[row_ids[:, :, None], col_ids[:, None, :]]
    wc = torch.where(row_valid[:, :, None] & col_valid[:, None, :], wc, 0)
    return xg, wc.contiguous()


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, row_ids: torch.Tensor,
                   col_ids: torch.Tensor, row_valid: torch.Tensor,
                   col_valid: torch.Tensor) -> torch.Tensor:
    """Compact FLGW matmul. x (B, M), w (M, N), row_ids (G, capM),
    col_ids (G, capN) -> y (B, N); columns no group holds stay zero."""
    b = x.shape[0]
    n = w.shape[1]
    yc = grouped_bmm(*gather_operands(x, w, row_ids, col_ids, row_valid,
                                      col_valid))
    # Padding slots write to the sink column n, which is sliced off.
    flat_cols = torch.where(col_valid, col_ids, n).reshape(-1)
    y = x.new_zeros((b, n + 1))
    y[:, flat_cols] = yc.permute(1, 0, 2).reshape(b, -1)
    return y[:, :n]
