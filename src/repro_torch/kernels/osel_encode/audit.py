"""Launch spec of ``csrc/osel_encode.cu``'s ``osel_encode``, for the
launch audit (``repro_torch.analysis.kernel_audit``).

A grid-stride kernel: ``min(ceil(items / 256), 132 * 16)`` blocks of 256
threads walk the work items, each 4 rows x 16 columns of the mask; the
audit indexes the tiles by work item.
"""
from __future__ import annotations

from repro_torch.analysis.kernel_audit import (LaunchCase, LaunchSpec, Tile,
                                               cdiv, register_launch_spec)

CHUNK, ROWS, THREADS, MAX_BLOCKS = 16, 4, 256, 132 * 16


def osel_encode(p: dict) -> list:
    m, n = p["m"], p["n"]
    n_chunks = cdiv(n, CHUNK)
    items = n_chunks * cdiv(m, ROWS)

    def rows(w, _y, _z):
        return (w // n_chunks * ROWS,)

    def cols(w, _y, _z):
        return (w % n_chunks * CHUNK,)
    return [LaunchCase(
        f"M{m} N{n}", "osel_encode", "osel_encode_kernel",
        (min(cdiv(items, THREADS), MAX_BLOCKS), 1, 1), (THREADS, 1, 1), 0,
        work=(items, 1, 1),
        tiles=(Tile("ig", (m,), (ROWS,), rows),
               Tile("og", (n,), (CHUNK,), cols),
               Tile("mask", (m, n), (ROWS, CHUNK),
                    lambda w, y, z: rows(w, y, z) + cols(w, y, z),
                    role="out")),
        tags=("grid_stride",))]


def _args(args):
    _, _, _, m, n = args
    return dict(m=m, n=n)


# the paper's Fig. 10 shapes, the IC3Net widths, a ragged edge and a
# grid past MAX_BLOCKS
CORPUS = (dict(m=128, n=512), dict(m=512, n=128), dict(m=128, n=160),
          dict(m=40, n=10), dict(m=9, n=37), dict(m=4096, n=4096))

register_launch_spec(LaunchSpec(
    "osel_encode", "osel_encode", ("osel_encode_kernel",), osel_encode,
    CORPUS, _args))
