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
import functools

import torch

from repro_torch.kernels import KernelEntry, check_operand, on_cpu
from repro_torch.kernels.flgw_matmul import ref as _ref
from repro_torch.sharding import collectives

_P, _I = ctypes.c_void_p, ctypes.c_int
BMM = KernelEntry("flgw_matmul", "grouped_bmm_f32",
                  [_P, _P, _P, _I, _I, _I, _I, _I])
BMM16 = KernelEntry("flgw_matmul", "grouped_bmm_bf16",
                    [_P, _P, _P, _I, _I, _I, _I, _I])
FUSED = KernelEntry("flgw_matmul", "fused_bmm",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I])
# fused_bmm's bf16 decode route: calls of at most _ROWS rows stream wc in
# blocks of _COLS columns and up to 8 rows; K splits in multiples of the
# _DEPTH-deep k-step, at most _MAX_SPLIT k-rows (what a block stages)
_ROWS, _COLS, _DEPTH, _MAX_SPLIT = 64, 64, 32, 512
# grouped_bmm_bf16's routes, the C entry's route argument
WMMA, TMA = 0, 1
# grouped_bmm_f32's blocks: _F32_ROWS rows x 32 or 64 columns
_F32_ROWS = 32
# Columns of y past n: n is the sink the padding slots write to, sliced
# off; 8 of them keep y's rows 16-byte aligned (for n a multiple of 8),
# which the flash kernels' tensor-core route needs of the v it is handed.
SINK_COLS = 8
# compact_weights gathers this many bytes of int64 indices at a time
_INDEX_BYTES = 1 << 30


def grouped_bmm(xg: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """(G, B, capM) @ (G, capM, capN) -> (G, B, capN) in xg's dtype, f32
    accumulation; bf16 (``grouped_bmm_bf16``, on the route
    :func:`bmm_bf16_route` picks) or float32 (``grouped_bmm_f32``, in
    tiles :func:`bmm_f32_cols` sizes) on the card. See
    :func:`ref.ref_grouped_bmm`."""
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
        xp, wp = xg.data_ptr(), wc.data_ptr()
        if xg.dtype == torch.bfloat16:
            route = bmm_bf16_route(b, k, n, xp % 16 == 0 and wp % 16 == 0)
            BMM16(xg.device, xp, wp, y.data_ptr(), g, b, k, n, route)
        else:
            cols = bmm_f32_cols(g, b, n, _sm_count(xg.device.index))
            BMM(xg.device, xp, wp, y.data_ptr(), g, b, k, n, cols)
    return y


def bmm_bf16_route(b: int, k: int, n: int, aligned: bool) -> int:
    """The route of a bf16 ``grouped_bmm`` call with B rows, K x N
    weights and operands 16-byte aligned or not: :data:`TMA` (TMA +
    wgmma) for more than ``_ROWS`` rows, K > 0 and K, N multiples of 8
    (TMA's 16-byte row strides) on aligned operands; :data:`WMMA` (the
    first design) for every other call."""
    tma = b > _ROWS and k > 0 and k % 8 == 0 and n % 8 == 0 and aligned
    return TMA if tma else WMMA


def bmm_f32_cols(g: int, b: int, n: int, sms: int) -> int:
    """The columns of a float32 ``grouped_bmm`` block (``_F32_ROWS``
    rows) on a card with ``sms`` SMs: 32 while the call's 32-column
    blocks fit the card in one wave (the MARL path's calls: latency
    bound, so more, smaller blocks finish sooner), 64 when they would
    not (fewer blocks, each reusing its x tile over more columns)."""
    blocks = g * -(-b // _F32_ROWS) * -(-n // 32)
    return 32 if blocks <= sms else 64


def gather_x(x: torch.Tensor, row_ids: torch.Tensor,
             row_valid: torch.Tensor) -> torch.Tensor:
    """Step 1: x (B, M) -> x_c (G, B, capM), padding slots zeroed. With
    a leading expert axis, x (E, B, M) and plan leaves (E, G, capM) give
    the E·G tiles (E·G, B, capM) from one gather: the experts'
    activations side by side as (B, E·M), expert e's ids offset by
    e·M."""
    b, m = x.shape[-2:]
    cap_m = row_ids.shape[-1]
    if x.dim() == 3:
        e = x.shape[0]
        if e > 1:
            row_ids = row_ids + torch.arange(
                e, device=x.device)[:, None, None] * m
            x = x.transpose(0, 1)
        x = x.reshape(b, e * m)
    xg = x[:, row_ids.reshape(-1)].reshape(b, -1, cap_m).permute(1, 0, 2)
    return torch.where(row_valid.reshape(-1, 1, cap_m), xg, 0).contiguous()


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, row_ids: torch.Tensor,
                   col_ids: torch.Tensor, row_valid: torch.Tensor,
                   col_valid: torch.Tensor, *, group=None) -> torch.Tensor:
    """Compact FLGW matmul. x (B, M), w (M, N), row_ids (G, capM),
    col_ids (G, capN) -> y (B, N); columns no group holds stay zero.

    With a leading expert axis, x (E, B, M), w (E, M, N) and plan
    leaves (E, G, cap) give y (E, B, N): the gathers and the scatter are
    batched and the E·G compact tiles go through one ``grouped_bmm``
    launch (the counterpart of JAX's vmap over the Pallas call).

    ``group``: as :func:`grouped_matmul_fused`'s. Each rank compacts
    only its capN/m columns of every tile from ``w`` (:func:`col_share`
    of the column ids) and computes them in the one launch."""
    wc = compact_weights(w, row_ids, col_share(col_ids, group), row_valid,
                         col_share(col_valid, group))
    yc = grouped_bmm(gather_x(x, row_ids, row_valid), wc.flatten(0, -3))
    return gather_cols(yc, col_ids, col_valid, w.shape[-1], group)


def col_share(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of a compact tile's capN columns, the last axis
    of ``t`` (column ids or validity (..., G, capN), compact weights
    (..., G, capM, capN)): the rank's chunk among the ``group``'s m
    equal chunks, in rank order (a view; ``t`` itself without a group).
    m must divide capN."""
    m = collectives.size(group)
    if t.shape[-1] % m:
        raise ValueError(f"capN {t.shape[-1]} does not split over {m} "
                         "ranks")
    return collectives.shard(t, group, -1)


def gather_cols(yc: torch.Tensor, col_ids: torch.Tensor,
                col_valid: torch.Tensor, n: int, group) -> torch.Tensor:
    """Every rank's :func:`col_share` of the compact outputs (..., B,
    capN/m), all-gathered over ``group`` in rank order, then scattered to
    the dense y (:func:`scatter_cols`) with the whole tiles' ids."""
    return scatter_cols(collectives.unshard(yc, group, -1), col_ids,
                        col_valid, n)


def scatter_cols(yc: torch.Tensor, col_ids: torch.Tensor,
                  col_valid: torch.Tensor, n: int) -> torch.Tensor:
    """Step 4: compact outputs (G, B, capN) -> y (B, n), or with a
    leading expert axis (E·G, B, capN) and plan leaves (E, G, capN) -> y
    (E, B, n). One scatter into a (B, E·(n+SINK_COLS)) buffer, expert
    e's columns offset by e·(n+SINK_COLS); padding slots write to their
    expert's sink column n, which is sliced off."""
    b = yc.shape[1]
    width = n + SINK_COLS
    e = col_ids.shape[0] if col_ids.dim() == 3 else 1
    cols = torch.where(col_valid, col_ids, n)
    if e > 1:
        cols = cols + torch.arange(e, device=yc.device)[:, None, None] * width
    y = yc.new_zeros((b, e * width))
    y[:, cols.reshape(-1)] = yc.permute(1, 0, 2).reshape(b, -1)
    if col_ids.dim() == 2:
        return y[:, :n]
    return y.view(b, e, width)[:, :, :n].transpose(0, 1)


def compact_weights(w: torch.Tensor, row_ids: torch.Tensor,
                    col_ids: torch.Tensor, row_valid: torch.Tensor,
                    col_valid: torch.Tensor) -> torch.Tensor:
    """Step 2, ``W -> W_c`` (..., G, capM, capN): the weight half of the
    encode output, invalid slots zeroed. Leading dims (stacked layers or
    experts) go through batched gathers, as many layers at a time as
    keep the gather's index tensors near ``_INDEX_BYTES``: indexing
    broadcasts its three int64 index tensors to the output's shape, 42
    GB for arctic-480b's 128 experts at once."""
    rows, cols = row_ids[..., None], col_ids[..., None, :]
    keep = row_valid[..., None] & col_valid[..., None, :]
    if w.dim() == 2:            # one layer: no layer index
        return torch.where(keep, w[rows, cols], 0)
    lead = w.shape[:-2]
    m, n = w.shape[-2:]
    g, cap_m, cap_n = keep.shape[-3:]
    wf = w.reshape(-1, m, n)
    rows, cols = rows.reshape(-1, g, cap_m, 1), cols.reshape(-1, g, 1, cap_n)
    keep = keep.reshape(-1, g, cap_m, cap_n)
    count = wf.shape[0]
    step = max(1, _INDEX_BYTES // (24 * g * cap_m * cap_n))
    parts = []
    for i in range(0, count, step):
        j = min(i + step, count)
        layer = torch.arange(i, j, device=w.device)[:, None, None, None]
        parts.append(torch.where(keep[i:j], wf[layer, rows[i:j], cols[i:j]],
                                 0))
    wc = parts[0] if len(parts) == 1 else torch.cat(parts)
    return wc.reshape(*lead, g, cap_m, cap_n)


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
    splits, k_split = (k_splits(g, b, k, n, _sm_count(xt.device.index))
                       if bf16 else (1, k))
    part = (torch.empty((splits, g, b, n), dtype=torch.float32,
                        device=xt.device) if splits > 1 else None)
    if y.numel():
        FUSED(xt.device, xt.data_ptr(), wc.data_ptr(), ids.data_ptr(),
              y.data_ptr(), None if part is None else part.data_ptr(), g, b,
              k, n, int(bf16), splits, k_split)
    return y


def k_splits(g: int, b: int, k: int, n: int,
             sms: int) -> tuple[int, int]:
    """(splits, k-rows per split) of a bf16 ``fused_bmm`` call on a card
    with ``sms`` SMs. More than ``_ROWS`` rows (prefill) take no split.
    With fewer (decode) the blocks of 64 columns and up to 8 rows fill
    few SMs, so K is split until there are about two blocks per SM; each
    split covers a multiple of the 32-deep k-step, at most 512 k-rows."""
    if b > _ROWS or k <= _DEPTH:
        return 1, k
    tiles = g * -(-n // _COLS) * -(-b // (4 if b <= 4 else 8))
    want = min(-(-k // _DEPTH), max(1, -(-2 * sms // tiles)))
    k_split = min(_MAX_SPLIT, -(-(-(-k // want)) // _DEPTH) * _DEPTH)
    return -(-k // k_split), k_split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sink_transposed(x: torch.Tensor) -> torch.Tensor:
    """x (..., B, M) -> (..., M+1, B): transposed, with the zero sink row
    M that invalid slots gather."""
    b, m = x.shape[-2:]
    xt = x.new_empty((*x.shape[:-2], m + 1, b))
    xt.narrow(-2, 0, m).copy_(x.mT)
    xt.select(-2, m).zero_()
    return xt


def fused_operands(x: torch.Tensor, row_ids: torch.Tensor,
                   row_valid: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_bmm``'s activation operands: x (B, M) and plan leaves (G,
    capM) give xt (M+1, B) (:func:`sink_transposed`) and int32 ids (G,
    capM). With a leading expert axis, x (E, B, M) and leaves (E, G,
    capM) give xt (E·(M+1), B) and ids (E·G, capM): the experts'
    sink-transposed activations stacked, expert e's ids offset by
    e·(M+1), so each keeps its own zero sink row."""
    m = x.shape[-1]
    xt = sink_transposed(x)
    ids = torch.where(row_valid, row_ids, m)
    if x.dim() == 3:
        e = x.shape[0]
        if e > 1:
            ids = ids + torch.arange(e, device=x.device)[:, None, None] * (
                m + 1)
        xt, ids = xt.flatten(0, 1), ids.flatten(0, 1)
    return xt, ids.to(torch.int32)


def grouped_matmul_fused(x: torch.Tensor, wc: torch.Tensor,
                         row_ids: torch.Tensor, row_valid: torch.Tensor,
                         col_ids: torch.Tensor, col_valid: torch.Tensor, *,
                         n: int, group=None) -> torch.Tensor:
    """Compact FLGW matmul on attached compact weights. x (B, M),
    wc (G, capM, capN) -> y (B, n); columns no group holds stay zero.

    Invalid row slots point at a zero row appended to x (transposed, so
    the kernel's gather reads runs of consecutive rows); invalid column
    slots scatter into a sink column that is sliced off (torch has no
    ``mode="drop"``).

    With a leading expert axis, x (E, B, M), wc (E, G, capM, capN) and
    plan leaves (E, G, cap) give y (E, B, n) from one ``fused_bmm``
    launch over the E·G tiles (:func:`fused_operands`).

    ``group``: a process group of m ranks that split every tile's capN
    output columns (the reference's ``"flgw_cap"`` rule, the paper's
    multi-core split; m must divide capN): each rank computes its capN/m
    columns of every tile in the one launch, from a copy of its slice of
    the replicated ``wc`` (:func:`col_share`), and the compact outputs
    are all-gathered over the group before the scatter
    (:func:`gather_cols`). Every rank then holds the whole y.
    """
    xt, ids = fused_operands(x, row_ids, row_valid)
    wc = col_share(wc, group).contiguous()
    return gather_cols(fused_bmm(xt, wc.flatten(0, -3), ids), col_ids,
                       col_valid, n, group)
