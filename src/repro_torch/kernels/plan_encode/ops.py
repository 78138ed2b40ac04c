"""Capacity-balanced group assignment (plan encode) on the CUDA kernels.

Two routes on a CUDA tensor, picked by :func:`assign_route`, an explicit
shape test:

* **sort** (every side of the IC3Net and gemma2-2b paths): one launch of
  ``plan_assign`` a grouping side, straight from the f32 scores, read in
  place through their strides, to the (G, cap) item lists and each
  item's group;
* **tiled** (sides past the sort route's limits), as
  ``repro.kernels.plan_encode.ops``:

  1. argmax   scores -> (pref, strength) per item, padded to the tile
  2. kernels  ``rank`` (comparator-rank count + tile histograms), then
              ``place`` (prefix sums + closed-form slot of every item)
  3. scatter  slot of each item -> (G, cap) item lists (inverse
              permutation) and each item's group

Each route launches the CUDA kernels of ``csrc/plan_encode.cu`` for CUDA
tensors; a CPU tensor takes the plain versions of ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelEntry, check_operand, on_cpu
from repro_torch.kernels.plan_encode import ref as _ref
from repro_torch.kernels.tiling import compute_cap

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
RANK = KernelEntry("plan_encode", "plan_rank", [_P, _P, _P, _P, _I, _I, _I, _I])
PLACE = KernelEntry("plan_encode", "plan_place",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I])
ASSIGN = KernelEntry("plan_encode", "plan_assign",
                     [_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL])
MAX_BLOCK = 1024   # one thread per item of a tile
# The sort route's limits, the C entry's kAssignMaxItems and
# kAssignMaxGroups. Items: one CTA sorts a whole layer, and the largest
# tier, 1024 threads (the most a CTA takes) x 16 items, fills the 64
# registers a thread gets at 1024 threads (it spills ~0.5 KB a thread)
# and 66 KB of the 227 KB of shared memory. Groups: the histogram and its
# four prefixes take 5 ints a group of shared memory, 20 KB at 1024.
SORT_MAX_ITEMS = 16384
SORT_MAX_GROUPS = 1024

preferences = _ref.preferences   # step 1 of the tiled route


def assign_route(m: int, g: int) -> str:
    """``"sort"`` when one CTA can hold a side of ``m`` items in ``g``
    groups, else ``"tiled"``."""
    if 1 <= m <= SORT_MAX_ITEMS and 1 <= g <= SORT_MAX_GROUPS:
        return "sort"
    return "tiled"


def _check_tile(mp: int, bi: int) -> None:
    if not 0 < bi <= MAX_BLOCK or mp % bi:
        raise ValueError(f"tile side {bi} must be in (0, {MAX_BLOCK}] and "
                         f"divide the padded item count {mp}")


def rank(pref: torch.Tensor, strength: torch.Tensor, g: int,
         bi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, Mp) int32 pref + float32 strength -> (rank (L, Mp),
    hist (L, Mp/bi, G)), int32. See :func:`ref.ref_rank`."""
    if on_cpu(pref, strength):
        return _ref.ref_rank(pref, strength, g, bi)
    check_operand(pref, "pref", torch.int32, 2)
    check_operand(strength, "strength", torch.float32, 2)
    if strength.shape != pref.shape:
        raise ValueError(f"pref {tuple(pref.shape)} and strength "
                         f"{tuple(strength.shape)} differ in shape")
    l, mp = pref.shape
    _check_tile(mp, bi)
    out = torch.empty_like(pref)
    hist = torch.empty((l, mp // bi, g), dtype=torch.int32,
                       device=pref.device)
    if l:
        RANK(pref.device, pref.data_ptr(), strength.data_ptr(),
             out.data_ptr(), hist.data_ptr(), l, mp, g, bi)
    return out, hist


def place(pref: torch.Tensor, rank_: torch.Tensor, hist: torch.Tensor,
          g: int, cap: int) -> torch.Tensor:
    """(L, Mp) pref/rank + (L, n_it, G) hist -> (L, Mp) int32 slot ids.
    See :func:`ref.ref_place`."""
    if on_cpu(pref, rank_, hist):
        return _ref.ref_place(pref, rank_, hist, g, cap)
    check_operand(pref, "pref", torch.int32, 2)
    check_operand(rank_, "rank", torch.int32, 2)
    check_operand(hist, "hist", torch.int32, 3)
    l, mp = pref.shape
    if rank_.shape != pref.shape or hist.shape[0] != l \
            or hist.shape[2] != g or hist.shape[1] == 0:
        raise ValueError(f"pref {tuple(pref.shape)}, rank "
                         f"{tuple(rank_.shape)} and hist {tuple(hist.shape)} "
                         f"do not fit together for G={g}")
    bi = mp // hist.shape[1]
    _check_tile(mp, bi)
    out = torch.empty_like(pref)
    if l:
        PLACE(pref.device, pref.data_ptr(), rank_.data_ptr(),
              hist.data_ptr(), out.data_ptr(), l, mp, g, cap, bi)
    return out


def _assign_sorted(scores: torch.Tensor, axis: int, m: int, g: int,
                   cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort route: one ``plan_assign`` launch over every stacked
    layer, reading the scores in place through their strides."""
    if scores.dtype != torch.float32:
        raise ValueError(f"plan_assign takes float32 scores, got "
                         f"{scores.dtype}")
    flat = scores.reshape(-1, *scores.shape[-2:])
    l = flat.shape[0]
    s_layer, s_row, s_col = flat.stride()
    s_item, s_group = (s_row, s_col) if axis else (s_col, s_row)
    ids = torch.empty((l, g * cap), dtype=torch.int64, device=flat.device)
    group = torch.empty((l, m), dtype=torch.int64, device=flat.device)
    if l:
        ASSIGN(flat.device, flat.data_ptr(), ids.data_ptr(),
               group.data_ptr(), l, m, g, cap, s_layer, s_item, s_group)
    return ids, group


def assign(scores: torch.Tensor, axis: int, slack: float = 1.0, *,
           block: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Deal items into equal-capacity groups by argmax preference.

    ``scores``: (..., M, G) if axis==1 (rows of IG) or (..., G, N) if
    axis==0 (columns of OG); leading dims batch over stacked layers and go
    through one launch of each kernel. Returns ``(ids, group)``: (..., G,
    cap) int64 item ids with ``cap = ceil(M/G * slack)`` (padding slots
    hold M), and (..., M) int64, the group holding each item. Bitwise
    equal to :func:`ref.ref_assign`. A CUDA tensor takes the route of
    :func:`assign_route`; ``block`` is the tiled route's tile side.
    """
    scores = scores.detach()
    lead = scores.shape[:-2]
    m, g = (scores.shape[-2:] if axis else scores.shape[-2:][::-1])
    cap = compute_cap(m, g, slack)
    if on_cpu(scores):
        ids, group = _ref.ref_assign(scores, axis, slack, block)
    elif assign_route(m, g) == "sort":
        ids, group = _assign_sorted(scores, axis, m, g, cap)
    else:
        pref, strength, bi = preferences(scores, axis, block)
        slot = place(pref, *rank(pref, strength, g, bi), g, cap)
        ids, group = _ref.ids_from_slots(slot[:, :m], m, g, cap)
    return ids.reshape(*lead, g, cap), group.reshape(*lead, m)


def balanced_assign(scores: torch.Tensor, axis: int, slack: float = 1.0, *,
                    block: int | None = None) -> torch.Tensor:
    """The (..., G, cap) item ids of :func:`assign`. Bitwise equal to
    :func:`ref.ref_balanced_assign` on every layer."""
    return assign(scores, axis, slack, block=block)[0]
