"""Compact FLGW matmul on the CUDA kernels of ``csrc/flgw_matmul.cu``.

Pipeline, as in ``repro.kernels.flgw_matmul.ops.grouped_matmul``:

  1. gather   x -> x_c (G, B, capM)     activations of each group
  2. gather   W -> W_c (G, capM, capN)  the unmasked weights only
  3. kernel   y_c = x_c @ W_c           ``grouped_bmm`` (FLOPs / G)
  4. scatter  y_c -> y (B, N)           compact outputs to dense columns

:func:`grouped_matmul_fused` is the serving variant: step 2's ``W_c``
comes from :func:`compact_weights`, attached once per params version,
and step 1's gather moves into the ``fused_bmm`` kernel, which takes x
transposed so that each gathered id is a run of consecutive rows. The kernels
mask ragged tile edges themselves, so nothing is padded to a tile.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelEntry, check_operand, on_cpu
from repro_torch.kernels.flgw_matmul import ref as _ref

_P, _I = ctypes.c_void_p, ctypes.c_int
BMM = KernelEntry("flgw_matmul", "grouped_bmm_f32", [_P, _P, _P, _I, _I, _I, _I])
BMM16 = KernelEntry("flgw_matmul", "grouped_bmm_bf16",
                    [_P, _P, _P, _I, _I, _I, _I])
FUSED = KernelEntry("flgw_matmul", "fused_bmm",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I])
_TILE, _DEPTH = 64, 32      # fused_bmm's bf16 row/column tile and k-step


def grouped_bmm(xg: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """(G, B, capM) @ (G, capM, capN) -> (G, B, capN) in xg's dtype, f32
    accumulation; bf16 (``grouped_bmm_bf16``) or float32
    (``grouped_bmm_f32``) on the card. See :func:`ref.ref_grouped_bmm`."""
    if on_cpu(xg, wc):
        return _ref.ref_grouped_bmm(xg, wc)
    if xg.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"xg: the kernel takes bf16 or float32, got "
                         f"{xg.dtype}")
    check_operand(xg, "xg", xg.dtype, 3)
    check_operand(wc, "wc", xg.dtype, 3)
    g, b, k = xg.shape
    if wc.shape[:2] != (g, k):
        raise ValueError(f"xg {tuple(xg.shape)} and wc {tuple(wc.shape)} "
                         "do not chain")
    n = wc.shape[2]
    y = torch.empty((g, b, n), dtype=xg.dtype, device=xg.device)
    if y.numel():
        entry = BMM16 if xg.dtype == torch.bfloat16 else BMM
        entry(xg.device, xg.data_ptr(), wc.data_ptr(), y.data_ptr(), g, b, k,
              n)
    return y


def gather_x(x: torch.Tensor, row_ids: torch.Tensor,
             row_valid: torch.Tensor) -> torch.Tensor:
    """Step 1: x (B, M) -> x_c (G, B, capM), padding slots zeroed."""
    b = x.shape[0]
    g, cap_m = row_ids.shape
    xg = x[:, row_ids.reshape(-1)].reshape(b, g, cap_m).permute(1, 0, 2)
    return torch.where(row_valid[:, None, :], xg, 0).contiguous()


def gather_w(w: torch.Tensor, row_ids: torch.Tensor, col_ids: torch.Tensor,
             row_valid: torch.Tensor, col_valid: torch.Tensor
             ) -> torch.Tensor:
    """Step 2: W (M, N) -> W_c (G, capM, capN), padding slots zeroed."""
    wc = w[row_ids[:, :, None], col_ids[:, None, :]]
    wc = torch.where(row_valid[:, :, None] & col_valid[:, None, :], wc, 0)
    return wc.contiguous()


def gather_operands(x: torch.Tensor, w: torch.Tensor, row_ids: torch.Tensor,
                    col_ids: torch.Tensor, row_valid: torch.Tensor,
                    col_valid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-2: the compact operands ``(x_c, W_c)`` of one layer, with
    the padding slots zeroed."""
    return (gather_x(x, row_ids, row_valid),
            gather_w(w, row_ids, col_ids, row_valid, col_valid))


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


def compact_weights(w: torch.Tensor, row_ids: torch.Tensor,
                    col_ids: torch.Tensor, row_valid: torch.Tensor,
                    col_valid: torch.Tensor) -> torch.Tensor:
    """``W -> W_c`` (..., G, capM, capN): the weight half of the encode
    output, invalid slots zeroed. Leading dims (stacked layers) go
    through one batched gather."""
    lead = w.shape[:-2]
    m, n = w.shape[-2:]
    g, cap_m = row_ids.shape[-2:]
    cap_n = col_ids.shape[-1]
    wf = w.reshape(-1, m, n)
    layer = torch.arange(wf.shape[0], device=w.device)[:, None, None, None]
    wc = wf[layer, row_ids.reshape(-1, g, cap_m, 1),
            col_ids.reshape(-1, g, 1, cap_n)]
    keep = (row_valid.reshape(-1, g, cap_m, 1)
            & col_valid.reshape(-1, g, 1, cap_n))
    return torch.where(keep, wc, 0).reshape(*lead, g, cap_m, cap_n)


def fused_bmm(xt: torch.Tensor, wc: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """(M+1, B) xt (the activations transposed, row M zero), (G, capM,
    capN) wc, (G, capM) int32 ids in [0, M] -> (G, B, capN) in xt's
    dtype; bf16 or float32 on the card. See :func:`ref.ref_fused_bmm`."""
    if on_cpu(xt, wc, ids):
        return _ref.ref_fused_bmm(xt, wc, ids)
    if xt.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"xt: the kernel takes bf16 or float32, got "
                         f"{xt.dtype}")
    check_operand(xt, "xt", xt.dtype, 2)
    check_operand(wc, "wc", xt.dtype, 3)
    check_operand(ids, "ids", torch.int32, 2)
    b = xt.shape[1]
    g, k, n = wc.shape
    if ids.shape != (g, k):
        raise ValueError(f"ids {tuple(ids.shape)} and wc {tuple(wc.shape)} "
                         "do not fit")
    y = torch.empty((g, b, n), dtype=xt.dtype, device=xt.device)
    bf16 = xt.dtype == torch.bfloat16
    splits, k_split = _k_splits(g, b, k, n, xt.device) if bf16 else (1, k)
    part = (torch.empty((splits, g, b, n), dtype=torch.float32,
                        device=xt.device) if splits > 1 else None)
    if y.numel():
        FUSED(xt.device, xt.data_ptr(), wc.data_ptr(), ids.data_ptr(),
              y.data_ptr(), None if part is None else part.data_ptr(), g, b,
              k, n, int(bf16), splits, k_split)
    return y


def _k_splits(g: int, b: int, k: int, n: int,
              device: torch.device) -> tuple[int, int]:
    """(splits, k-rows per split) of a bf16 ``fused_bmm`` call. With at
    most one row tile (decode) the column tiles alone fill few of the
    card's SMs, so K is split until there are about two blocks per SM;
    each split covers a multiple of the 32-deep k-step."""
    if b > _TILE or k <= _DEPTH:
        return 1, k
    tiles = g * -(-n // _TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(-(-k // _DEPTH), max(1, -(-2 * sms // tiles)))
    k_split = -(-(-(-k // want)) // _DEPTH) * _DEPTH
    return -(-k // k_split), k_split


def sink_transposed(x: torch.Tensor) -> torch.Tensor:
    """x (B, M) -> (M+1, B): transposed, with the zero sink row M that
    invalid slots gather."""
    b, m = x.shape
    xt = x.new_empty((m + 1, b))
    xt[:m].copy_(x.T)
    xt[m].zero_()
    return xt


def grouped_matmul_fused(x: torch.Tensor, wc: torch.Tensor,
                         row_ids: torch.Tensor, row_valid: torch.Tensor,
                         col_ids: torch.Tensor, col_valid: torch.Tensor, *,
                         n: int) -> torch.Tensor:
    """Compact FLGW matmul on attached compact weights. x (B, M),
    wc (G, capM, capN) -> y (B, n); columns no group holds stay zero.

    Invalid row slots point at a zero row appended to x (transposed, so
    the kernel's gather reads runs of consecutive rows); invalid column
    slots scatter into a sink column that is sliced off (torch has no
    ``mode="drop"``).
    """
    b, m = x.shape
    ids = torch.where(row_valid, row_ids, m).to(torch.int32)
    yc = fused_bmm(sink_transposed(x), wc, ids)              # (G, B, capN)
    flat_cols = torch.where(col_valid, col_ids, n).reshape(-1)
    y = x.new_zeros((b, n + 1))
    y[:, flat_cols] = yc.permute(1, 0, 2).reshape(b, -1)
    return y[:, :n]
