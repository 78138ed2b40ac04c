"""Capacity-balanced group assignment (plan encode) on the CUDA kernels.

Pipeline, as in ``repro.kernels.plan_encode.ops``:

  1. argmax   scores -> (pref, strength) per item, padded to the tile
  2. kernels  ``rank`` (comparator-rank count + tile histograms), then
              ``place`` (prefix sums + closed-form slot of every item)
  3. scatter  slot of each item -> (G, cap) item lists (inverse permutation)

``rank`` and ``place`` launch the CUDA kernels of ``csrc/plan_encode.cu``
for CUDA tensors and run their plain versions (``ref.py``) for CPU ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelEntry, check_operand, on_cpu
from repro_torch.kernels.plan_encode import ref as _ref
from repro_torch.kernels.tiling import compute_cap, plan_block, round_up

_P, _I = ctypes.c_void_p, ctypes.c_int
RANK = KernelEntry("plan_encode", "plan_rank", [_P, _P, _P, _P, _I, _I, _I, _I])
PLACE = KernelEntry("plan_encode", "plan_place",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I])
MAX_BLOCK = 1024   # one thread per item of a tile


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


def preferences(scores: torch.Tensor, axis: int, block: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Step 1: ``(pref, strength, bi)`` of every item, flattened to
    (L, Mp) and padded to a multiple of the tile side ``bi``. Padding
    items carry the sentinel group G and strength -inf: never counted,
    never placed (their slots are sliced off)."""
    scores = scores.detach()
    if axis == 0:
        scores = scores.transpose(-1, -2)
    m, g = scores.shape[-2:]
    flat = scores.reshape(-1, m, g)
    pref = flat.argmax(-1).to(torch.int32)
    strength = flat.amax(-1).to(torch.float32)
    bi = plan_block(m, block)
    pad = round_up(m, bi) - m
    l = flat.shape[0]
    pref = torch.cat([pref, pref.new_full((l, pad), g)], dim=1)
    strength = torch.cat(
        [strength, strength.new_full((l, pad), float("-inf"))], dim=1)
    return pref, strength, bi


def balanced_assign(scores: torch.Tensor, axis: int, slack: float = 1.0, *,
                    block: int | None = None) -> torch.Tensor:
    """Deal items into equal-capacity groups by argmax preference.

    ``scores``: (..., M, G) if axis==1 (rows of IG) or (..., G, N) if
    axis==0 (columns of OG); leading dims batch over stacked layers and go
    through one launch of each kernel. Returns (..., G, cap) int64 item
    ids with ``cap = ceil(M/G * slack)``; padding slots hold M. Bitwise
    equal to :func:`ref.ref_balanced_assign`. ``block`` overrides the
    tile side (tests force small tiles to drive the multi-tile path).
    """
    lead = scores.shape[:-2]
    m, g = (scores.shape[-2:] if axis else scores.shape[-2:][::-1])
    cap = compute_cap(m, g, slack)
    pref, strength, bi = preferences(scores, axis, block)
    slot = place(pref, *rank(pref, strength, g, bi), g, cap)[:, :m]
    # Inverse permutation. Every real item's slot lies in [0, G*cap) and
    # is unique, so the scatter writes each slot at most once.
    l = pref.shape[0]
    ids = torch.full((l, g * cap), m, dtype=torch.int64, device=pref.device)
    ids.scatter_(1, slot.long(),
                 torch.arange(m, device=pref.device).expand(l, m))
    return ids.reshape(*lead, g, cap)
