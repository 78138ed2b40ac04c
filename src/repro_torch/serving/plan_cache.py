"""Process-wide PlanState cache keyed by the grouping-layout signature.

Port of ``repro.serving.plan_cache``: every ``ServeSession`` and every
request a scheduler admits resolves its plans here, so consumers of one
params version share one encode. The key is ``(structure fingerprint,
capacity slack, uint32 layout signature, device)``: the device keeps a
CPU session from receiving plans that live on the card. A lookup costs
one signature pass (and one device sync to read it), only a miss
encodes. Cached states
are layout-only: compact weights are stripped before they are stored.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional

from repro_torch.core import encoder as planenc
from repro_torch.core import grouped
from repro_torch.core.grouped import iter_flgw_layers

MAX_ENTRIES = 8

_LOCK = threading.Lock()
_CACHE: OrderedDict[tuple, planenc.PlanState] = OrderedDict()
_STATS = {"hits": 0, "misses": 0, "encodes": 0}


def structure_key(params: dict) -> tuple:
    """Host-side fingerprint of a param tree's FLGW structure: the layer
    paths and grouping-matrix shapes."""
    return tuple((path, tuple(p["ig"].shape), tuple(p["og"].shape))
                 for path, p in iter_flgw_layers(params))


def shared_plans(params: dict, *, encode: Callable[[], planenc.PlanState],
                 slack: float = 1.0,
                 sig: Optional[int] = None) -> planenc.PlanState:
    """The PlanState of ``params`` through the process-wide cache.
    ``encode`` builds it on a miss; ``sig`` skips the signature pass when
    the caller has it. Thread-safe; the encode runs outside the lock."""
    if sig is None:
        sig = int(planenc.plan_signature(params))
    device = next((p["ig"].device for _, p in iter_flgw_layers(params)), None)
    key = (structure_key(params), float(slack), int(sig), str(device))
    with _LOCK:
        state = _CACHE.get(key)
        if state is not None:
            _CACHE.move_to_end(key)
            _STATS["hits"] += 1
            return state
        _STATS["misses"] += 1
    state = encode()
    if not isinstance(state, planenc.PlanState):
        raise TypeError(
            f"encode() must return a PlanState, got {type(state).__name__}")
    if grouped.has_compact(state.plans):
        state = state._replace(plans=grouped.strip_compact(state.plans))
    with _LOCK:
        _STATS["encodes"] += 1
        _CACHE[key] = state
        _CACHE.move_to_end(key)
        while len(_CACHE) > MAX_ENTRIES:
            _CACHE.popitem(last=False)
    return state


def stats() -> dict:
    with _LOCK:
        return dict(_STATS, entries=len(_CACHE))


def clear() -> None:
    """Drop every cached PlanState and zero the counters."""
    with _LOCK:
        _CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0
