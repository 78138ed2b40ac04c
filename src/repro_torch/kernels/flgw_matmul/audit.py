"""Launch specs of ``csrc/flgw_matmul.cu``: ``grouped_bmm_f32``,
``grouped_bmm_bf16`` and ``fused_bmm``, for the launch audit
(``repro_torch.analysis.kernel_audit``).

Each model follows its C entry's launch code: the route (the wrapper's
own ``ops.bmm_f32_cols``, ``ops.bmm_bf16_route`` and ``ops.k_splits``
pick the arguments, the entry's shape tests pick the kernel), then the
kernel's grid, block, cluster, shared memory and each CTA's tile of the
operands and the output. The corpus holds the IC3Net widths and the
model shapes of PERF.md section 6.
"""
from __future__ import annotations

from repro_torch.analysis.kernel_audit import (SMS, LaunchCase, LaunchSpec,
                                               Tile, cdiv,
                                               register_launch_spec)
from repro_torch.kernels.flgw_matmul.ops import (TMA, bmm_bf16_route,
                                                 bmm_f32_cols, k_splits)
from repro_torch.kernels.tiling import compute_cap

LIB = "flgw_matmul"
ROWS = 64                     # kWM, the wmma kernels' rows a block
F32_ROWS, F32_K = 32, 64      # kFM, kFK
TMA_M, TMA_N, TMA_K, TMA_STAGES = 128, 256, 64, 4
TMA_SMEM = TMA_STAGES * (TMA_M * TMA_K * 2 + (TMA_N // 64) * TMA_K * 64 * 2) \
    + 2 * TMA_STAGES * 8 + 1024
# clusters of 2 the card holds at once (cudaOccupancyMaxActiveClusters
# at one CTA an SM); chip_smoke.py checks the grids it gives
TMA_RESIDENT_CLUSTERS = SMS // 2
WG_M, WG_N, WG_K, WG_STAGES = 256, 128, 64, 4
WG_SMEM = WG_STAGES * (WG_K * WG_M * 2 + WG_K * WG_N * 2) + 1024
WG_MAX_K = (232_448 - WG_SMEM) // 4 // WG_K * WG_K
S_COLS, S_THREADS, S_MAX_SPLIT = 64, 256, 512
F32_BM = F32_BN = 64          # fused_bmm_f32_kernel's tile, kBK = 16


def _wmma_static(bn: int, fused: bool) -> int:
    """Static shared memory of fused_bmm_bf16_kernel / grouped_bmm_bf16_
    kernel<bn>: the larger of the operand tiles and the f32 epilogue
    tile (+ the fused kernel's 32 staged ids)."""
    xs_ld = ROWS + 8 if fused else 32 + 8
    load = ((32 if fused else ROWS) * xs_ld + 32 * (bn + 8)) * 2
    store = ROWS * (bn + 4) * 4
    return max(load, store) + (32 * 4 if fused else 0)


def _gbn(g, b, n, rows, cols, zmap=lambda z: z):
    """Tiles of a (G, B, N) output in rows x cols blocks on grid
    (columns, rows, groups)."""
    return lambda x, y, z: (zmap(z), y * rows, x * cols)


# -- grouped_bmm_f32 -----------------------------------------------------------

def grouped_bmm_f32(p: dict) -> list:
    g, b, k, n = p["g"], p["b"], p["k"], p["n"]
    cols = p.get("cols") or bmm_f32_cols(g, b, n, p.get("sms", SMS))
    grid = (cdiv(n, cols), cdiv(b, F32_ROWS), g)
    return [LaunchCase(
        f"G{g} B{b} K{k} N{n}", "grouped_bmm_f32",
        f"grouped_bmm_f32_kernel<{cols}>", grid, (256, 1, 1), 0,
        static_smem=4 * (2 * F32_ROWS * F32_K + 2 * F32_K * cols),
        tiles=(
            Tile("x", (g, b, k), (1, F32_ROWS, k),
                 lambda x, y, z: (z, y * F32_ROWS, 0)),
            Tile("w", (g, k, n), (1, k, cols),
                 lambda x, y, z: (z, 0, x * cols)),
            Tile("y", (g, b, n), (1, F32_ROWS, cols),
                 _gbn(g, b, n, F32_ROWS, cols), role="out")),
        tags=(f"cols{cols}",))]


# -- grouped_bmm_bf16 ----------------------------------------------------------

def grouped_bmm_bf16(p: dict) -> list:
    g, b, k, n = p["g"], p["b"], p["k"], p["n"]
    route = p["route"] if "route" in p else bmm_bf16_route(
        b, k, n, p.get("aligned", True))
    label = f"G{g} B{b} K{k} N{n}"
    if route == TMA:
        resident = p.get("resident", TMA_RESIDENT_CLUSTERS)
        ct = cdiv(n, TMA_N)
        per_g = cdiv(b, 2 * TMA_M) * ct
        pairs = per_g * g
        clusters = min(pairs, resident)

        def y_of(r, pair, _):
            gi, rem = pair // per_g, pair % per_g
            return gi, (rem // ct * 2 + r) * TMA_M, rem % ct * TMA_N
        return [LaunchCase(
            label, "grouped_bmm_bf16", "grouped_bmm_tma_kernel",
            (2 * clusters, 1, 1), (384, 1, 1), TMA_SMEM, cluster=(2, 1, 1),
            work=(2, pairs, 1),
            tiles=(
                Tile("x", (g, b, k), (1, TMA_M, k),
                     lambda r, pair, _: (y_of(r, pair, _)[0],
                                         y_of(r, pair, _)[1], 0),
                     empty_ok=True),
                Tile("w", (g, k, n), (1, k, TMA_N),
                     lambda r, pair, _: (y_of(r, pair, _)[0], 0,
                                         y_of(r, pair, _)[2])),
                Tile("y", (g, b, n), (1, TMA_M, TMA_N), y_of, role="out",
                     empty_ok=True)),
            tags=("tma", "persistent"))]
    bn = 128 if b > ROWS else 64
    return [LaunchCase(
        label, "grouped_bmm_bf16", f"grouped_bmm_bf16_kernel<{bn}>",
        (cdiv(n, bn), cdiv(b, ROWS), g), (128, 1, 1), 0,
        static_smem=_wmma_static(bn, fused=False),
        tiles=(
            Tile("x", (g, b, k), (1, ROWS, k),
                 lambda x, y, z: (z, y * ROWS, 0)),
            Tile("w", (g, k, n), (1, k, bn), lambda x, y, z: (z, 0, x * bn)),
            Tile("y", (g, b, n), (1, ROWS, bn), _gbn(g, b, n, ROWS, bn),
                 role="out")),
        tags=("wmma",))]


# -- fused_bmm -----------------------------------------------------------------

def fused_bmm(p: dict) -> list:
    g, b, k, n = p["g"], p["b"], p["k"], p["n"]
    bf16 = p.get("is_bf16", 1)
    label = f"G{g} B{b} K{k} N{n}" + ("" if bf16 else " f32")
    if not bf16:
        return [LaunchCase(
            label, "fused_bmm", "fused_bmm_f32_kernel",
            (cdiv(n, F32_BN), cdiv(b, F32_BM), g), (256, 1, 1), 0,
            static_smem=4 * (16 * (F32_BM + 1) + 16 * F32_BN + 16),
            tiles=(Tile("xt", (b,), (F32_BM,), lambda x, y, z: (y * F32_BM,)),
                   Tile("wc", (g, k, n), (1, k, F32_BN),
                        lambda x, y, z: (z, 0, x * F32_BN)),
                   Tile("y", (g, b, n), (1, F32_BM, F32_BN),
                        _gbn(g, b, n, F32_BM, F32_BN), role="out")))]
    if "splits" in p:
        splits, k_split = p["splits"], p["k_split"]
    else:
        splits, k_split = k_splits(g, b, k, n, p.get("sms", SMS))
    wide = n % 8 == 0 and p.get("wc_aligned", True)
    if b > ROWS and wide and b % 8 == 0 and p.get("xt_aligned", True):
        return [LaunchCase(
            label, "fused_bmm", "fused_bmm_wgmma_kernel",
            (cdiv(n, WG_N), cdiv(b, WG_M), g), (256, 1, 1),
            WG_SMEM + 4 * min(k, WG_MAX_K),
            tiles=(Tile("xt", (b,), (WG_M,), lambda x, y, z: (y * WG_M,)),
                   Tile("wc", (g, k, n), (1, k, WG_N),
                        lambda x, y, z: (z, 0, x * WG_N)),
                   Tile("y", (g, b, n), (1, WG_M, WG_N),
                        _gbn(g, b, n, WG_M, WG_N), role="out")),
            tags=("wgmma",) + (("ids_past_smem",) if k > WG_MAX_K else ()))]
    if b <= ROWS and wide and (splits > 1 or k <= S_MAX_SPLIT):
        rb = 4 if b <= 4 else 8
        kn = min(k, k_split)
        if splits > 1:
            out = Tile("part", (splits, g, b, n), (1, 1, rb, S_COLS),
                       lambda x, y, z: (y, z % g, z // g * rb, x * S_COLS),
                       role="out")
        else:
            out = Tile("y", (g, b, n), (1, rb, S_COLS),
                       lambda x, y, z: (z % g, z // g * rb, x * S_COLS),
                       role="out")
        launches = [LaunchCase(
            label, "fused_bmm", f"fused_bmm_stream_kernel<{rb}>",
            (cdiv(n, S_COLS), splits, g * cdiv(b, rb)), (S_THREADS, 1, 1),
            4 * (kn * rb + (S_THREADS // 32) * rb * S_COLS),
            tiles=(Tile("xt", (b,), (rb,), lambda x, y, z: (z // g * rb,)),
                   Tile("wc", (g, k, n), (1, k_split, S_COLS),
                        lambda x, y, z: (z % g, y * k_split, x * S_COLS)),
                   out),
            split_axes=(1,) if splits > 1 else (),
            tags=("stream", f"splits{splits}"))]
    else:
        bn = 128 if b > ROWS else 64
        if splits > 1:
            out = Tile("part", (splits, g, b, n), (1, 1, ROWS, bn),
                       lambda x, y, z: (z // g, z % g, y * ROWS, x * bn),
                       role="out")
        else:
            out = Tile("y", (g, b, n), (1, ROWS, bn),
                       lambda x, y, z: (z % g, y * ROWS, x * bn),
                       role="out")
        launches = [LaunchCase(
            label, "fused_bmm", f"fused_bmm_bf16_kernel<{bn}>",
            (cdiv(n, bn), cdiv(b, ROWS), g * splits), (128, 1, 1), 0,
            static_smem=_wmma_static(bn, fused=True),
            tiles=(Tile("xt", (b,), (ROWS,), lambda x, y, z: (y * ROWS,)),
                   Tile("wc", (g, k, n), (1, k_split, bn),
                        lambda x, y, z: (z % g, z // g * k_split, x * bn)),
                   out),
            tags=("wmma", f"splits{splits}"))]
    if splits > 1:
        count = g * b * n
        launches.append(LaunchCase(
            label, "fused_bmm", "reduce_splits_kernel",
            (cdiv(count, 256), 1, 1), (256, 1, 1), 0,
            tiles=(Tile("part", (splits * count,), (256,),
                        lambda x, y, z: (x * 256,)),
                   Tile("y", (count,), (256,), lambda x, y, z: (x * 256,),
                        role="out")),
            tags=("split_k_reduce",)))
    return launches


# -- corpus --------------------------------------------------------------------

def _cap(m: int, g: int = 4, slack: float = 1.25) -> int:
    return compute_cap(m, g, slack)


# IC3Net (hidden 128, 8 agents, G = 4): B = 16 envs x 8 agents rows
IC3NET_F32 = tuple(dict(g=4, b=b, k=k, n=n)
                   for b in (128, 64, 32)
                   for k, n in ((10, 40), (32, 160), (40, 32), (160, 3)))
# gemma2-2b training (d 2304, d_ff 9216, G = 4, B x S = 4096 rows)
GEMMA_TRAIN = tuple(dict(g=4, b=4096, k=k, n=n)
                    for k, n in ((_cap(2304), _cap(9216)),
                                 (_cap(9216), _cap(2304))))
BF16_CORPUS = GEMMA_TRAIN + (
    # mixtral-8x22b's training dispatch: E·G = 32 tiles x 640 rows
    dict(g=32, b=640, k=_cap(6144), n=_cap(16384)),
    dict(g=32, b=640, k=_cap(16384), n=_cap(6144)),
    # mamba2-1.3b: the in projection's 2,660 compact columns (wmma)
    dict(g=4, b=4096, k=_cap(2048), n=2660),
    dict(g=4, b=4096, k=_cap(4096), n=_cap(2048)),
    # whisper-large-v3: 6,000 and 1,792 rows
    dict(g=4, b=6000, k=400, n=1600), dict(g=4, b=6000, k=1600, n=400),
    dict(g=4, b=1792, k=400, n=400),
    # ragged and unaligned: few rows, widths not multiples of 8
    dict(g=4, b=48, k=100, n=70), dict(g=4, b=200, k=64, n=128,
                                       aligned=False),
)
FUSED_CORPUS = (
    # gemma2-2b serve: prefill 4096 rows, decode 4 rows
    dict(g=4, b=4096, k=_cap(2304), n=_cap(9216)),
    dict(g=4, b=4096, k=_cap(9216), n=_cap(2304)),
    dict(g=4, b=4, k=_cap(2304), n=_cap(9216)),
    dict(g=4, b=4, k=_cap(9216), n=_cap(2304)),
    # gemma2-27b's down projection: K = 11,520, ids past shared memory
    dict(g=4, b=4096, k=11520, n=_cap(4608)),
    dict(g=4, b=4, k=11520, n=_cap(4608)),
    # mixtral-8x22b's experts: 32 tiles x 8,192 and 8 rows
    dict(g=32, b=8192, k=_cap(6144), n=_cap(16384)),
    dict(g=32, b=8, k=_cap(16384), n=_cap(6144)),
    # arctic-480b's experts: 512 tiles x 1,024 and 8 rows
    dict(g=512, b=1024, k=_cap(7168), n=_cap(4864)),
    dict(g=512, b=8, k=_cap(4864), n=_cap(7168)),
    # mamba2-1.3b's in projection: 2,660 columns (wmma, split-K decode)
    dict(g=4, b=4096, k=_cap(2048), n=2660),
    dict(g=4, b=4, k=_cap(2048), n=2660),
    # whisper-large-v3: 6,000 and 1,792 rows, 4-row decode
    dict(g=4, b=6000, k=400, n=400), dict(g=4, b=1792, k=400, n=1600),
    dict(g=4, b=4, k=1600, n=400),
    # an f32 call
    dict(g=4, b=128, k=40, n=160, is_bf16=0),
)


# the params of one recorded call from its KernelEntry arguments
# (pointers as ints, then the integers, in the C entry's order)

def _f32_args(args):
    _, _, _, g, b, k, n, cols = args
    return dict(g=g, b=b, k=k, n=n, cols=cols)


def _bf16_args(args):
    _, _, _, g, b, k, n, route = args
    return dict(g=g, b=b, k=k, n=n, route=route)


def _fused_args(args):
    xt, wc, _, _, _, g, b, k, n, bf16, splits, k_split = args
    return dict(g=g, b=b, k=k, n=n, is_bf16=bf16, splits=splits,
                k_split=k_split, xt_aligned=xt % 16 == 0,
                wc_aligned=wc % 16 == 0)


register_launch_spec(LaunchSpec(
    "grouped_bmm_f32", LIB, ("grouped_bmm_f32_kernel",), grouped_bmm_f32,
    IC3NET_F32, _f32_args))
register_launch_spec(LaunchSpec(
    "grouped_bmm_bf16", LIB,
    ("grouped_bmm_tma_kernel", "grouped_bmm_bf16_kernel"), grouped_bmm_bf16,
    BF16_CORPUS, _bf16_args))
register_launch_spec(LaunchSpec(
    "fused_bmm", LIB,
    ("fused_bmm_wgmma_kernel", "fused_bmm_stream_kernel",
     "fused_bmm_bf16_kernel", "fused_bmm_f32_kernel",
     "reduce_splits_kernel"), fused_bmm, FUSED_CORPUS, _fused_args))

