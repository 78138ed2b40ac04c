"""Plain PyTorch versions of the plan-encode kernels, and the sort oracle.

``ref_rank`` and ``ref_place`` compute what the CUDA kernels ``plan_rank``
and ``plan_place`` compute, term by term (padding items included), so the
card can hold each kernel bitwise against them. ``ref_assign`` is the
plain version of ``plan_assign``: the same chain on the CPU (preferences,
rank, place, the inverse permutation and each item's group).
``ref_balanced_assign`` is the semantic ground truth of the whole
assignment: the lexsort deal of ``repro.kernels.plan_encode.ref``,
written as two stable sorts because torch has no ``lexsort``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tiling import compute_cap, plan_block, round_up


def preferences(scores: torch.Tensor, axis: int, block: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(pref, strength, bi)`` of every item, flattened to (L, Mp) and
    padded to a multiple of the tile side ``bi``. Padding items carry the
    sentinel group G and strength -inf: never counted, never placed
    (their slots are sliced off)."""
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


def ref_rank(pref: torch.Tensor, strength: torch.Tensor, g: int,
             bi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, Mp) pref/strength -> rank (L, Mp), hist (L, Mp/bi, G), int32.

    ``rank[i]`` counts the items of ``i``'s group that sort before it:
    stronger, or equally strong with a lower index. ``hist`` is the group
    histogram of each ``bi``-item tile (padding items carry ``pref == g``
    and drop out of it).
    """
    l, mp = pref.shape
    idx = torch.arange(mp, device=pref.device)
    ranks = []
    for i0 in range(0, mp, bi):     # one i-tile at a time: (L, bi, Mp) pairs
        pi = pref[:, i0:i0 + bi, None]
        si = strength[:, i0:i0 + bi, None]
        ii = idx[i0:i0 + bi, None]
        sj = strength[:, None, :]
        before = (sj > si) | ((sj == si) & (idx[None, :] < ii))
        ranks.append(((pref[:, None, :] == pi) & before).sum(-1))
    rank = torch.cat(ranks, dim=1).to(torch.int32)
    groups = torch.arange(g, device=pref.device)
    hist = (pref.reshape(l, mp // bi, bi, 1) == groups).sum(2)
    return rank, hist.to(torch.int32)


def ref_place(pref: torch.Tensor, rank: torch.Tensor, hist: torch.Tensor,
              g: int, cap: int) -> torch.Tensor:
    """(L, Mp) pref/rank + (L, n_it, G) hist -> (L, Mp) int32 slot ids.

    Kept items (``rank < cap``) go to ``pref*cap + rank``; overflow items
    take the free slots in ascending order, found by matching their global
    overflow rank against each group's free-slot range.
    """
    counts = hist.sum(1)                                     # (L, G)
    kcount = counts.clamp(max=cap)
    ovf = counts - kcount
    nfree = cap - kcount
    ovf_before = (ovf.cumsum(-1) - ovf)[:, None, :]          # exclusive
    free_before = (nfree.cumsum(-1) - nfree)[:, None, :]
    groups = torch.arange(g, device=pref.device)
    onehot = (pref[..., None] == groups).to(counts.dtype)    # (L, Mp, G)
    keep = rank < cap
    kept_slot = pref * cap + rank.clamp(max=cap - 1)
    q = (onehot * ovf_before).sum(-1) + rank - cap
    match = ((q[..., None] >= free_before)
             & (q[..., None] < free_before + nfree[:, None, :])
             ).to(counts.dtype)
    gsel = (match * groups).sum(-1)
    kc_sel = (match * kcount[:, None, :]).sum(-1)
    lo_sel = (match * free_before).sum(-1)
    ovf_slot = gsel * cap + kc_sel + (q - lo_sel)
    return torch.where(keep, kept_slot, ovf_slot).to(torch.int32)


def ids_from_slots(slot: torch.Tensor, m: int, g: int,
                   cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, M) slot of every real item -> ``(ids (L, G*cap), group (L, M))``,
    int64: the inverse permutation (padding slots hold ``m``) and the
    group holding each item, ``slot // cap``. Every real item's slot lies
    in [0, G*cap) and is unique, so the scatter writes each slot at most
    once."""
    l = slot.shape[0]
    slot = slot.long()
    ids = torch.full((l, g * cap), m, dtype=torch.int64, device=slot.device)
    ids.scatter_(1, slot, torch.arange(m, device=slot.device).expand(l, m))
    return ids, slot // cap


def ref_assign(scores: torch.Tensor, axis: int, slack: float = 1.0,
               block: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``plan_assign``: ``scores`` (..., M, G) with
    axis==1 or (..., G, N) with axis==0 -> ``(ids (L, G*cap), group
    (L, M))``, int64, the leading dims flattened to L. ``block`` is the
    tile side of the rank/place chain; the answer does not depend on it."""
    m, g = (scores.shape[-2:] if axis else scores.shape[-2:][::-1])
    cap = compute_cap(m, g, slack)
    pref, strength, bi = preferences(scores, axis, block)
    slot = ref_place(pref, *ref_rank(pref, strength, g, bi), g, cap)
    return ids_from_slots(slot[:, :m], m, g, cap)


def ref_balanced_assign(scores: torch.Tensor,
                        slack: float = 1.0) -> torch.Tensor:
    """Lexsort oracle. ``scores``: (M, G); returns (G, cap) int64 item ids
    (padding slots hold ``M``).

    Items are sorted by (argmax group asc, strength desc, index asc); each
    group keeps its ``cap`` strongest items, and overflow items take the
    remaining free slots in ascending slot order.
    """
    m, g = scores.shape
    dev = scores.device
    cap = compute_cap(m, g, slack)
    total = g * cap
    pref = scores.argmax(1)
    strength = scores.amax(1)
    # lexsort((-strength, pref)) as two stable sorts: secondary key first.
    by_strength = torch.sort(-strength, stable=True).indices
    order = by_strength[torch.sort(pref[by_strength], stable=True).indices]
    pref_sorted = pref[order]
    first = torch.searchsorted(pref_sorted, torch.arange(g, device=dev))
    rank = torch.arange(m, device=dev) - first[pref_sorted]
    keep = rank < cap
    kept_slot = pref_sorted * cap + rank.clamp(max=cap - 1)
    counts = torch.bincount(pref, minlength=g).clamp(max=cap)
    sidx = torch.arange(total, device=dev)
    taken = (sidx % cap) < counts[sidx // cap]
    free_slots = torch.sort(taken.to(torch.int8), stable=True).indices
    ovf_rank = (~keep).cumsum(0) - 1
    slot = torch.where(keep, kept_slot,
                       free_slots[ovf_rank.clamp(0, total - 1)])
    row_of_slot = torch.full((total,), m, dtype=torch.int64, device=dev)
    row_of_slot[slot] = order
    return row_of_slot.reshape(g, cap)
