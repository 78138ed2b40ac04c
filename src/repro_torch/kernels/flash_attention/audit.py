"""Launch specs of ``csrc/flash_attention.cu``: ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv``, for the launch audit
(``repro_torch.analysis.kernel_audit``).

The route is the C entry's ``tc_shape`` test (``flash_attention.cu``):
bf16 with D a multiple of 16 up to 256 and 16-byte aligned rows takes
the tensor-core kernels, instantiated at D rounded up to 64, 128 or 256;
anything else the FP32 FMA kernels. The corpus holds the head shapes of
every served and trained model of PERF.md section 6.
"""
from __future__ import annotations

from repro_torch.analysis.kernel_audit import (LaunchCase, LaunchSpec, Tile,
                                               cdiv, register_launch_spec)

LIB = "flash_attention"
THREADS = 256
BQ, BKV = 64, 32              # FP32 FMA: query rows a block, keys a step
DKV_BK, DKV_BQ = 32, 32
TC_BQ, TC_BK, TC_BQD = 128, 64, 64


def tc_route(d: int, is_bf16: bool, aligned: bool) -> bool:
    """``tc_shape``: the tensor-core route."""
    return bool(is_bf16) and d % 16 == 0 and d <= 256 and aligned


def _kd(d: int) -> int:
    return 64 if d <= 64 else 128 if d <= 128 else 256


def _label(p: dict) -> str:
    return (f"B{p['b']} H{p['hq']}/{p['hkv']} S{p['s']} T{p['t']} "
            f"D{p['d']}" + ("" if p.get("is_bf16", 1) else " f32"))


def _q_tiles(p, rows, qmap):
    """q, out (or dq) and lse tiles of a grid whose query tile and head
    and batch come from ``qmap(x, y, z) -> (b, h, q0)``."""
    b, hq, s, d = p["b"], p["hq"], p["s"], p["d"]

    def q(x, y, z):
        bi, h, q0 = qmap(x, y, z)
        return bi, h, q0, 0
    return (Tile("q", (b, hq, s, d), (1, 1, rows, d), q),
            lambda name, role="out": Tile(name, (b, hq, s, d),
                                          (1, 1, rows, d), q, role=role))


def _kv(p, hmap):
    """k and v read whole (every key of the head) by each CTA."""
    b, hkv, t, d = p["b"], p["hkv"], p["t"], p["d"]

    def org(x, y, z):
        bi, hk = hmap(x, y, z)
        return bi, hk, 0, 0
    return (Tile("k", (b, hkv, t, d), (1, 1, t, d), org),
            Tile("v", (b, hkv, t, d), (1, 1, t, d), org))


def flash_fwd(p: dict) -> list:
    b, hq, hkv, s, d = p["b"], p["hq"], p["hkv"], p["s"], p["d"]
    qpk = hq // hkv
    if tc_route(d, p.get("is_bf16", 1), p.get("aligned", True)):
        kd, nq = _kd(d), cdiv(s, TC_BQ)

        def qmap(x, y, z):
            return y, x, (nq - 1 - z) * TC_BQ
        qt, out = _q_tiles(p, TC_BQ, qmap)
        return [LaunchCase(
            _label(p), "flash_fwd", f"flash_fwd_wgmma_kernel<{kd}>",
            (hq, b, nq), (THREADS, 1, 1),
            2 * (TC_BQ + 4 * TC_BK) * kd + 1024,
            tiles=(qt, *_kv(p, lambda x, y, z: (y, x // qpk)), out("out"),
                   Tile("lse", (b, hq, s), (1, 1, TC_BQ),
                        lambda x, y, z: qmap(x, y, z), role="out")),
            tags=("wgmma",))]
    ty = "bf16" if p.get("is_bf16", 1) else "float"

    def qmap(x, y, z):
        return z, y, x * BQ
    qt, out = _q_tiles(p, BQ, qmap)
    return [LaunchCase(
        _label(p), "flash_fwd", f"flash_fwd_kernel<{ty}>",
        (cdiv(s, BQ), hq, b), (THREADS, 1, 1),
        4 * (BQ * (d + 4) + BKV * (d + 4) + BKV * d),
        tiles=(qt, *_kv(p, lambda x, y, z: (z, y // qpk)), out("out"),
               Tile("lse", (b, hq, s), (1, 1, BQ), qmap, role="out")),
        tags=("fp32_fma",))]


def flash_bwd_dq(p: dict) -> list:
    b, hq, hkv, s, d = p["b"], p["hq"], p["hkv"], p["s"], p["d"]
    qpk = hq // hkv
    if tc_route(d, p.get("is_bf16", 1), p.get("aligned", True)):
        kd, nq = _kd(d), cdiv(s, TC_BQD)

        def qmap(x, y, z):
            return y, x, (nq - 1 - z) * TC_BQD
        qt, out = _q_tiles(p, TC_BQD, qmap)
        return [LaunchCase(
            _label(p), "flash_bwd_dq", f"flash_bwd_dq_mma_kernel<{kd}>",
            (hq, b, nq), (THREADS, 1, 1),
            2 * (2 * TC_BQD + 4 * TC_BK) * (kd + 8)
            + 4 * (8 * 8 * 32 + 8 * 4 * 32),
            tiles=(qt, out("dout", "in"),
                   *_kv(p, lambda x, y, z: (y, x // qpk)), out("dq")),
            tags=("mma",))]
    ty = "bf16" if p.get("is_bf16", 1) else "float"

    def qmap(x, y, z):
        return z, y, x * BQ
    qt, out = _q_tiles(p, BQ, qmap)
    return [LaunchCase(
        _label(p), "flash_bwd_dq", f"flash_bwd_dq_kernel<{ty}>",
        (cdiv(s, BQ), hq, b), (THREADS, 1, 1),
        4 * (2 * BQ + 2 * BKV) * (d + 4),
        tiles=(qt, out("dout", "in"), *_kv(p, lambda x, y, z: (z, y // qpk)),
               out("dq")),
        tags=("fp32_fma",))]


def flash_bwd_dkv(p: dict) -> list:
    b, hq, hkv, s, t, d = p["b"], p["hq"], p["hkv"], p["s"], p["t"], p["d"]
    if tc_route(d, p.get("is_bf16", 1), p.get("aligned", True)):
        kd, rows = _kd(d), TC_BK
        grid = (hkv, b, cdiv(t, TC_BK))

        def kmap(x, y, z):
            return y, x, z * TC_BK, 0
        kernel = f"flash_bwd_dkv_mma_kernel<{kd}>"
        smem = 2 * (2 * TC_BK + 4 * TC_BQD) * (kd + 8) \
            + 4 * (4 * TC_BQD + 8 * 8 * 32 + 8 * 16 * 32)
        tag = "mma"
    else:
        rows = DKV_BK
        grid = (cdiv(t, DKV_BK), hkv, b)

        def kmap(x, y, z):
            return z, y, x * DKV_BK, 0
        ty = "bf16" if p.get("is_bf16", 1) else "float"
        kernel = f"flash_bwd_dkv_kernel<{ty}>"
        smem = 4 * ((2 * DKV_BK + 2 * DKV_BQ) * (d + 4) + 2 * DKV_BQ)
        tag = "fp32_fma"
    qpk = hq // hkv

    def qhead(x, y, z):
        bi, hk, _, _ = kmap(x, y, z)
        return bi, hk * qpk, 0, 0
    kv = (b, hkv, t, d)
    return [LaunchCase(
        _label(p), "flash_bwd_dkv", kernel, grid, (THREADS, 1, 1), smem,
        tiles=(Tile("q", (b, hq, s, d), (1, qpk, s, d), qhead),
               Tile("dout", (b, hq, s, d), (1, qpk, s, d), qhead),
               Tile("k", kv, (1, 1, rows, d), kmap),
               Tile("v", kv, (1, 1, rows, d), kmap),
               Tile("dk", kv, (1, 1, rows, d), kmap, role="out"),
               Tile("dv", kv, (1, 1, rows, d), kmap, role="out")),
        tags=(tag,))]


def _shape(b, hq, hkv, s, d, **kw):
    return dict(b=b, hq=hq, hkv=hkv, s=s, t=kw.pop("t", s), d=d, **kw)


CORPUS = (
    _shape(4, 8, 4, 1024, 256),            # gemma2-2b
    _shape(4, 32, 16, 1024, 128),          # gemma2-27b
    _shape(4, 48, 8, 1024, 128),           # internlm2-20b, mixtral-8x22b
    _shape(4, 16, 8, 2048, 256),           # gemma3-12b
    _shape(1, 56, 8, 512, 128),            # arctic-480b
    _shape(2, 64, 8, 1024, 128),           # jamba-1.5-large
    _shape(4, 20, 20, 448, 64),            # whisper-large-v3's decoder
    _shape(2, 4, 2, 100, 64, is_bf16=0),   # f32, a ragged query tile
    _shape(2, 4, 2, 96, 36),               # bf16, D not a multiple of 16
    _shape(1, 4, 4, 130, 64, aligned=False),
)


def _fwd_args(args):
    (q, k, v, _, _, b, hq, hkv, s, t, d, qsb, qsh, qss, ksb, ksh, kss, vsb,
     vsh, vss, _, _, _, _, bf16) = args
    aligned = all(x % 16 == 0 for x in (q, k, v)) and all(
        st % 8 == 0 for st in (qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss))
    return dict(b=b, hq=hq, hkv=hkv, s=s, t=t, d=d, is_bf16=bf16,
                aligned=aligned)


def _bwd_args(n_ptr):
    def parse(args):
        ptrs = args[:n_ptr]
        b, hq, hkv, s, t, d = args[n_ptr:n_ptr + 6]
        bf16 = args[-1]
        aligned = all(x % 16 == 0 for x in (ptrs[0], ptrs[1], ptrs[2],
                                            ptrs[3]))
        return dict(b=b, hq=hq, hkv=hkv, s=s, t=t, d=d, is_bf16=bf16,
                    aligned=aligned)
    return parse


register_launch_spec(LaunchSpec(
    "flash_fwd", LIB, ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
    flash_fwd, CORPUS, _fwd_args))
register_launch_spec(LaunchSpec(
    "flash_bwd_dq", LIB, ("flash_bwd_dq_mma_kernel", "flash_bwd_dq_kernel"),
    flash_bwd_dq, CORPUS, _bwd_args(7)))
register_launch_spec(LaunchSpec(
    "flash_bwd_dkv", LIB,
    ("flash_bwd_dkv_mma_kernel", "flash_bwd_dkv_kernel"), flash_bwd_dkv,
    CORPUS, _bwd_args(8)))
