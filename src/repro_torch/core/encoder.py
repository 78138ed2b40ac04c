"""Plan encoder: cached compact layouts plus the signature they came from.

Port of ``repro.core.encoder``: encode, signature, the refresh policies
(``maybe_refresh`` for a training loop, ``refresh_if_stale`` for
serving) and the compact-weight attach. ``sig`` is the same uint32 hash
as the JAX package's, bit for bit, held in an int64 tensor: every
multiply and add is masked to 32 bits. Where JAX branches on the device
with ``lax.cond``, the refreshes branch on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import grouped
from repro_torch.core.schedule import REFRESH_MODES

_MIX = 2654435761        # Knuth's multiplicative-hash constant (odd)
_FOLD = 1000003          # layer-fold multiplier (odd)
_U32 = 0xFFFFFFFF


class PlanState(NamedTuple):
    """Cached sparse metadata of a param tree + the hash it was built from.

    ``plans`` mirrors the params nesting with a GroupPlan at every FLGW
    projection (``{}`` when the grouped path is off). ``sig`` is the
    layout signature (:func:`plan_signature`), a 0-d int64 tensor in
    ``[0, 2**32)``.
    """
    plans: Any
    sig: torch.Tensor

    def __bool__(self) -> bool:           # truthiness == "has any plans"
        return bool(self.plans)


def empty_state(device=None) -> PlanState:
    return PlanState({}, torch.zeros((), dtype=torch.int64, device=device))


def _layout_ranks(scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pref, rank) of one grouping side; ``scores``: (..., M, G).

    ``pref`` is each item's argmax group; ``rank`` its position within
    that group under (strength desc, index asc) -- together they fix the
    balanced deal's placement bitwise.
    """
    g = scores.shape[-1]
    pref = scores.argmax(-1)
    strength = scores.amax(-1)
    order = torch.argsort(-strength, dim=-1, stable=True)   # ties: index asc
    pref_sorted = pref.gather(-1, order)
    groups = torch.arange(g, device=scores.device)
    cnt = (pref_sorted[..., None] == groups).long().cumsum(-2)
    rank_sorted = cnt.gather(-1, pref_sorted[..., None])[..., 0] - 1
    rank = torch.zeros_like(rank_sorted).scatter_(-1, order, rank_sorted)
    return pref, rank


def plan_signature(params: dict) -> torch.Tensor:
    """uint32 hash (in an int64 tensor) of every FLGW layer's layout.

    Per layer and grouping side it hashes the argmax vector and the
    placement-rank vector with odd per-position weights, folding layers
    with an odd multiplier -- ``repro.core.encoder.plan_signature``'s
    arithmetic modulo 2**32. No product overflows int64: the values are
    below 2**31 and the weights below 2**32.
    """
    h = 0
    salt = 1
    for _, p in grouped.iter_flgw_layers(params):
        for scores in (p["ig"], p["og"].transpose(-1, -2)):
            for idx in _layout_ranks(scores.detach()):
                v = idx.reshape(-1).to(torch.int64)
                pos = torch.arange(v.shape[0], dtype=torch.int64,
                                   device=v.device)
                w = ((((pos * _MIX) & _U32) + salt) & _U32) | 1
                term = ((((v + 1) & _U32) * w) & _U32).sum() & _U32
                h = (((h * _FOLD) & _U32) + term) & _U32
                salt += 2
    return torch.as_tensor(h, dtype=torch.int64)


def encode_plans(params: dict, cfg) -> PlanState:
    """One encoding pass over a param tree: plans + their signature.
    ``cfg`` is the layer's FLGWConfig (anything with ``capacity_slack``)."""
    return PlanState(grouped.encode_plans(params, cfg),
                     plan_signature(params))


def attach_compact(state: PlanState, params: dict) -> PlanState:
    """Attach compact weights (``GroupPlan.wc``) to every plan in a state:
    gather once per params version, consume through the fused kernel
    until the params move. The signature is layout-only and does not
    certify ``wc``."""
    if not isinstance(state, PlanState) or not state.plans:
        return state
    return state._replace(plans=grouped.attach_compact(state.plans, params))


def _certify(state: PlanState, params: dict) -> PlanState:
    """The pass-through branch of a refresh: the layout is certified by
    ``sig``, but attached ``wc`` snapshot weight values the signature
    ignores, so they are re-gathered from the params certified against."""
    if grouped.has_compact(state.plans):
        return attach_compact(state, params)
    return state


def maybe_refresh(params: dict, state: PlanState, it, cfg,
                  schedule=None) -> PlanState:
    """Re-encode ``state`` from the current grouping matrices when due.

    ``schedule`` is a ``SparsitySchedule`` (None: refresh every step);
    its ``refresh`` field picks the policy: ``"period"`` every
    ``refresh_every`` steps (with ``refresh_every == 1`` always, without
    reading ``it``), ``"on_change"`` when the layout signature moved,
    ``"hybrid"`` on change or when the period is due. ``it`` is the step
    (an int or a 0-d tensor, read on the host). The pass-through branch
    certifies (re-attaching ``wc`` where the state carries it). Empty
    states pass through untouched.
    """
    if not isinstance(state, PlanState):
        raise TypeError(
            f"maybe_refresh needs a PlanState, got {type(state).__name__}; "
            "build one with encoder.encode_plans")
    if not state.plans:
        return state
    mode = "period" if schedule is None else \
        getattr(schedule, "refresh", "period")
    if mode not in REFRESH_MODES:
        raise ValueError(f"unknown refresh mode {mode!r}")
    k = 1 if schedule is None else max(1, schedule.refresh_every)

    def fresh() -> PlanState:
        new = encode_plans(params, cfg)
        if grouped.has_compact(state.plans):
            new = attach_compact(new, params)
        return new

    with torch.no_grad():
        if mode == "period" and k == 1:
            return fresh()
        due = int(it) % k == 0
        if mode == "period":
            pred = due
        else:
            changed = int(plan_signature(params)) != int(state.sig)
            pred = changed if mode == "on_change" else changed or due
        return fresh() if pred else _certify(state, params)


def refresh_if_stale(params: dict, state: PlanState, encode) -> PlanState:
    """Signature-gated re-encode with no step counter: the serving hook.

    One :func:`plan_signature` pass certifies the cached plans against
    the current params; a different layout triggers exactly one
    re-encode (``encode()``, the stack's own encode entry point), an
    unchanged one passes the state through (re-attaching ``wc`` when the
    state carries it). Where JAX branches on the device with
    ``lax.cond``, this compares on the host: one device sync per
    certification, to read the signature.
    """
    if not isinstance(state, PlanState):
        raise TypeError(
            f"refresh_if_stale needs a PlanState, got {type(state).__name__};"
            " build one with encoder.encode_plans")
    if not state.plans:
        return state
    sig = plan_signature(params)
    if int(sig) == int(state.sig):
        return _certify(state, params)
    fresh = encode()._replace(sig=sig)
    if grouped.has_compact(state.plans):
        fresh = attach_compact(fresh, params)
    return fresh
