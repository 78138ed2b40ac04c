"""Launch specs of ``csrc/plan_encode.cu``: ``plan_assign``,
``plan_rank`` and ``plan_place``, for the launch audit
(``repro_torch.analysis.kernel_audit``).

``plan_assign`` launches one CTA a stacked layer at the tier of its item
count (``by_tier``); its dynamic shared memory is the tier's cub sort
storage (:data:`ASSIGN_TEMP_BYTES`) plus the histogram, its four
prefixes and the overflow total. ``plan_rank`` and ``plan_place`` (the
tiled route, past ``ops.assign_route``'s limits) launch a CTA a tile of
``bi`` items a layer, ``bi = tiling.plan_block(m)``. The corpus holds
the IC3Net sides and the model sides of PERF.md section 6.
"""
from __future__ import annotations

from repro_torch.analysis.kernel_audit import (LaunchCase, LaunchSpec, Tile,
                                               cdiv, register_launch_spec)
from repro_torch.kernels.plan_encode.ops import assign_route
from repro_torch.kernels.tiling import compute_cap, plan_block, round_up

LIB = "plan_encode"
TILE_J = 1024                 # kTileJ: rank_kernel's staged j items

# (threads, items) tiers of by_tier, by item count
TIERS = ((128, (128, 1)), (512, (128, 4)), (2048, (256, 8)),
         (4096, (512, 8)), (10240, (512, 20)), (16384, (1024, 16)))
# the bytes of each tier's sort storage (AssignTier::kTempBytes: the
# union of cub's BlockRadixSort and BlockExchange storage, rounded up to
# 16), as the card's profiler records them (chip_smoke.py phase 18)
ASSIGN_TEMP_BYTES = {(128, 1): 4640, (128, 4): 4640, (256, 8): 9280,
                     (512, 8): 18528, (512, 20): 40960,
                     (1024, 16): 67584}


def tier(m: int) -> tuple:
    for top, t in TIERS:
        if m <= top:
            return t
    return TIERS[-1][1]


def plan_assign(p: dict) -> list:
    layers, m, g, cap = p["l"], p["m"], p["g"], p["cap"]
    threads, items = tier(m)
    return [LaunchCase(
        f"L{layers} M{m} G{g} cap{cap}", "plan_assign",
        f"plan_assign_kernel<{threads}, {items}>", (layers, 1, 1),
        (threads, 1, 1),
        ASSIGN_TEMP_BYTES[(threads, items)] + (5 * g + 1) * 4,
        tiles=(Tile("scores", (layers, m, g), (1, m, g),
                    lambda x, y, z: (x, 0, 0), ragged=False),
               Tile("ids", (layers, g * cap), (1, g * cap),
                    lambda x, y, z: (x, 0), role="out", ragged=False),
               Tile("group", (layers, m), (1, m), lambda x, y, z: (x, 0),
                    role="out", ragged=False)),
        tags=(f"tier{threads}x{items}",))]


def _tiled(p: dict):
    layers, g = p["l"], p["g"]
    bi = p.get("bi") or plan_block(p["m"])
    mp = p.get("mp") or round_up(p["m"], bi)
    return layers, g, bi, mp


def plan_rank(p: dict) -> list:
    layers, g, bi, mp = _tiled(p)
    return [LaunchCase(
        f"L{layers} Mp{mp} G{g} bi{bi}", "plan_rank", "rank_kernel",
        (mp // bi, layers, 1), (bi, 1, 1), g * 4,
        static_smem=2 * 4 * TILE_J,
        tiles=(Tile("pref", (layers, mp), (1, mp), lambda x, y, z: (y, 0),
                    ragged=False),
               Tile("strength", (layers, mp), (1, mp),
                    lambda x, y, z: (y, 0), ragged=False),
               Tile("rank", (layers, mp), (1, bi),
                    lambda x, y, z: (y, x * bi), role="out", ragged=False),
               Tile("hist", (layers, mp // bi, g), (1, 1, g),
                    lambda x, y, z: (y, x, 0), role="out", ragged=False)),
        tags=("tiled",))]


def plan_place(p: dict) -> list:
    layers, g, bi, mp = _tiled(p)
    return [LaunchCase(
        f"L{layers} Mp{mp} G{g} bi{bi}", "plan_place", "place_kernel",
        (mp // bi, layers, 1), (bi, 1, 1), 4 * g * 4,
        tiles=(Tile("hist", (layers, mp // bi, g), (1, mp // bi, g),
                    lambda x, y, z: (y, 0, 0), ragged=False),
               Tile("rank", (layers, mp), (1, bi),
                    lambda x, y, z: (y, x * bi), ragged=False),
               Tile("slot", (layers, mp), (1, bi),
                    lambda x, y, z: (y, x * bi), role="out", ragged=False)),
        tags=("tiled",))]


def _side(layers, m, g=4, slack=1.25):
    return dict(l=layers, m=m, g=g, cap=compute_cap(m, g, slack))


# IC3Net sides (hidden 128, 8 agents), gemma2-2b's (2,304 / 9,216 at 13
# and 26 layers), the 1024 x 16 tier (15,360-16,384 items), mixtral's
# expert sides (16,384 x 32, 6,144 x 32), arctic's (7,168 x 128) and
# whisper's (5,120 x 32)
ASSIGN_CORPUS = tuple(_side(1, m) for m in (10, 40, 128, 160)) + (
    _side(13, 2304), _side(26, 9216), _side(18, 16384), _side(1, 15360),
    _side(32, 16384), _side(32, 6144), _side(128, 7168), _side(32, 5120),
    _side(1, 100, g=1024, slack=1.0), _side(1, 513))
# past the sort route: gemma2-27b's d_ff sides (36,864 x 2), jamba's
# wide sides (24,576-33,152 x 1) and its experts' (24,576 x 16)
TILED_CORPUS = (dict(l=2, m=36864, g=4), dict(l=1, m=33152, g=4),
                dict(l=16, m=24576, g=4), dict(l=1, m=300, g=2048))
assert all(assign_route(c["m"], c["g"]) == "sort" for c in ASSIGN_CORPUS)
assert all(assign_route(c["m"], c["g"]) == "tiled" for c in TILED_CORPUS)


def _assign_args(args):
    _, _, _, layers, m, g, cap, _, _, _ = args
    return dict(l=layers, m=m, g=g, cap=cap)


def _rank_args(args):
    _, _, _, _, layers, mp, g, bi = args
    return dict(l=layers, m=mp, mp=mp, g=g, bi=bi)


def _place_args(args):
    _, _, _, _, layers, mp, g, _, bi = args
    return dict(l=layers, m=mp, mp=mp, g=g, bi=bi)


register_launch_spec(LaunchSpec(
    "plan_assign", LIB, ("plan_assign_kernel",), plan_assign, ASSIGN_CORPUS,
    _assign_args))
register_launch_spec(LaunchSpec(
    "plan_rank", LIB, ("rank_kernel",), plan_rank, TILED_CORPUS, _rank_args))
register_launch_spec(LaunchSpec(
    "plan_place", LIB, ("place_kernel",), plan_place, TILED_CORPUS,
    _place_args))
