"""ServeSession: the one serving surface.

Port of ``repro.serving.session``. A session owns the params version
being served, its prefill and decode steps, the cache factory for both
layouts (lockstep scalar ``pos`` and per-slot) and the ``plan_policy``
knob (``certify`` | ``trust`` | ``off``, see ``repro_torch.serving.steps``).
Plans resolve through the process-wide cache
(``repro_torch.serving.plan_cache``); the compact weights (``GroupPlan.wc``,
the fused kernel's operand) are attached session-locally, never stored
in the shared cache. ``debug_contracts=True`` makes every ``Engine`` on
the session run under ``repro_torch.analysis.contracts.no_retrace``. The
JAX session's ``jit`` switch has nothing to switch in eager PyTorch and
is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoder as planenc
from repro_torch.core.flgw import FLGWConfig
from repro_torch.models import transformer
from repro_torch.serving import plan_cache
from repro_torch.serving.steps import (check_plan_policy, make_decode_step,
                                       make_prefill_step)


class ServeSession:
    """One params version being served, with its plans and steps.

    ``plan_policy``: ``"certify"`` (default) re-resolves plans through
    the process-wide cache at every request boundary (a signature pass,
    an encode only when the layout moved); ``"trust"`` resolves them
    here and at :meth:`update_params` only; ``"off"`` caches none, so
    every grouped projection re-encodes per call and takes the gather
    path (``grouped_bmm``).
    ``banded``: the prefill's chunked attention core attends each chunk's
    KV band only (decode is unchanged).
    ``debug_contracts``: engines built on this session run their tick
    loop under ``contracts.no_retrace`` (one signature a step, ever).
    """

    def __init__(self, cfg, params, *, plan_policy: str = "certify",
                 banded: bool = False, debug_contracts: bool = False):
        self.cfg = cfg
        self.params = params
        self.debug_contracts = debug_contracts
        self.plan_policy = check_plan_policy(plan_policy)
        self._grouped = cfg.flgw_groups > 1 and cfg.flgw_path == "grouped"
        self._slack = FLGWConfig(groups=cfg.flgw_groups,
                                 path=cfg.flgw_path).capacity_slack
        self._decode = make_decode_step(cfg, banded=banded)
        self._prefill = make_prefill_step(cfg, plan_policy=plan_policy,
                                          banded=banded)
        self._wc_memo = None
        self.plans = self._resolve_plans()

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["embedding"].device

    @property
    def _cached(self) -> bool:
        return self._grouped and self.plan_policy != "off"

    # -- plan resolution ---------------------------------------------------

    def _resolve_plans(self):
        """The session's layout-only PlanState under the current params,
        through the process-wide cache; ``()`` under ``off`` or off the
        grouped path."""
        if not self._cached:
            return ()
        with torch.inference_mode():
            return plan_cache.shared_plans(
                self.params, slack=self._slack,
                encode=lambda: transformer.encode_plans(self.params,
                                                        self.cfg))

    def _attach(self, state):
        """This session's params compacted onto the shared layout,
        memoised on the (plans, params) pair; never mutates ``state``."""
        if not state:
            return state
        memo = self._wc_memo
        if memo and memo[0] is state and memo[1] is self.params:
            return memo[2]
        with torch.inference_mode():
            attached = planenc.attach_compact(state, self.params)
        self._wc_memo = (state, self.params, attached)
        return attached

    def update_params(self, params) -> None:
        """Publish a new params version: both ``certify`` and ``trust``
        re-resolve the plans here."""
        self.params = params
        self.plans = self._resolve_plans()

    def refresh(self, cache: dict) -> dict:
        """Request-boundary certification of a cache's PlanState under
        ``certify``; a no-op under ``trust`` and ``off``."""
        if self.plan_policy != "certify" or not self._grouped:
            return cache
        if not isinstance(cache.get("plans"), planenc.PlanState):
            return cache
        self.plans = self._resolve_plans()
        return dict(cache, plans=self._attach(self.plans))

    # -- caches ------------------------------------------------------------

    def new_cache(self, batch: int, max_seq: int, *,
                  per_slot: bool = False) -> dict:
        """Decode cache on the session's device carrying its plans per
        ``plan_policy``; ``per_slot=True`` is the continuous-batching
        layout."""
        cache = transformer.init_cache(self.cfg, batch, max_seq,
                                       per_slot=per_slot, device=self.device)
        cache["plans"] = self._attach(self.plans) if self._cached else ()
        return cache

    # -- steps -------------------------------------------------------------

    def decode(self, cache: dict, tokens, positions):
        """One greedy decode step: ``(next_tok, cache)``."""
        return self._decode(self.params, cache, tokens, positions)

    def prefill(self, batch, plans=...):
        """Full-sequence prefill -> last-position logits. ``plans``
        defaults to the session's PlanState with compact weights."""
        if plans is ...:
            plans = self._attach(self.plans) if self._cached else None
        if plans == ():
            plans = None
        return self._prefill(self.params, batch, plans)

    def greedy_positions(self, batch: int, pos: int) -> torch.Tensor:
        """(batch, 1) positions column for a lockstep decode step."""
        return torch.full((batch, 1), pos, dtype=torch.int64,
                          device=self.device)
